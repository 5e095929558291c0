// Packed flash-attention forward for Hopper (sm_90a), with or without the
// row logsumexp.
//
// Replaces: unigeo_tpu/ops/attention.py::flash_attention_tpu_packed
// (Pallas kernel _flash_packed_kernel) through unigeo_flash_attention_packed,
// unigeo_tpu/ops/attention.py::flash_attention_tpu (Pallas kernel
// _flash_kernel, the head-split layout [B, S, H, D]) through
// unigeo_flash_attention_headsplit, and
// unigeo_tpu/ops/attention.py::flash_attention_tpu_fwd_lse (Pallas
// kernel _flash_fwd_lse_kernel, the forward of the differentiable attention)
// through unigeo_flash_attention_fwd_lse.  The three entry points share one
// kernel body, instantiated as three kernels with their own names
// (flash_packed_*, flash_headsplit_*, flash_fwd_lse_*), so a profile tells
// them apart.  A contiguous [B, S, H, D] tensor has the bytes of [B, S, H*D],
// so the head-split entry needs no other body: the JAX package has a second
// Pallas kernel only because Mosaic's tiles want [B*H, S, D].  The lse entry
// also writes lse = m + log(l) per query row, f32,
// into a contiguous [B, H, Sq] tensor (no padded rows), the residual the
// backward kernels in flash_attention_bwd.cu recompute P from.  It computes, for every batch b and
// head h, softmax(q_h k_h^T * scale) v_h, where head h is the column slice
// [h*D, (h+1)*D) of a packed [B, S, H*D] row.  No transpose happens on either
// side: a block reads its head at column offset h*D of the packed rows and
// writes its output there.
//
// What bounds it on the H100: the work is 4*B*H*Sq*Sk*D operations against
// 2*B*H*D*(2*Sq + 2*Sk) bytes in bf16 (q, k, v read once, o written once),
// so at the UNet's first stage (Sq = Sk = 3072) it does Sq*Sk/(Sq+Sk) = 1536
// operations per byte: far above the ~295 at which the tensor cores
// (989 TF/s bf16) rather than memory (3.35 TB/s) become the limit.  The
// bound is the operations at every main-path shape.
//
// The exponentials are the other half of the work at D = 64: one per score
// against the 4*D = 256 operations of the two products, and the SFU's ex2
// rate (16 a clock per SM, ~3.7 T/s on the card) is about the tensor cores'
// rate in scores (989 TF/s / 256 ~ 3.9 T/s).  Run one after the other, the
// two take twice the bound; the wgmma body overlaps them.
//
// What this design does about it: the S x S score matrix never reaches
// device memory (online softmax with an f32 running max in log2 units, sum
// and accumulator, one key tile at a time in shared memory), and in bf16
// both products run on the tensor cores, f32 accumulate.
//
// Three block layouts, chosen by dtype and, in bf16, by head width in one
// switch (dispatch_bf16):
//
// * bf16, D in {16, 64} (the UNet's 64, and 16 for small checks):
//   flash_{packed,headsplit,fwd_lse}_wgmma_kernel<D>, Hopper's TMA and
//   wgmma (blocks from sm90.cuh).  A block owns 192 queries of one (batch,
//   head): a producer warpgroup (setmaxnreg 24) whose one thread loads q
//   once and keeps a 4-slot ring of 128-key k and v tiles full under full /
//   empty mbarriers (3-D tensor maps over the packed layout, 128-byte
//   swizzle at D = 64, 32-byte at D = 16), and three consumer warpgroups
//   (160 registers) of 64 query rows.  S = q k^T is an m64n128 wgmma with
//   both operands from shared memory (q is never held in registers); P
//   goes from the S accumulator into bf16 A registers for O += P v, whose B
//   is the v tile read MN-major (the transpose bit).  Each consumer issues
//   S of tile it with P v of tile it - 1 and runs tile it's softmax (one
//   ex2.approx.ftz per score, the scale folded into log2 units) while P v
//   runs; the consumers take turns to issue (named barriers), so one's
//   softmax runs under another's products.  Three consumers rather than
//   two (three warps a scheduler to hide the softmax's latencies), the
//   turns, the 4-slot ring and the 128-key tiles are the measured choices
//   of unigeo_tpu_torch/tools/forward_variants.py.  The TMA returns zero
//   rows past Sk, which would score 0, not -inf: the last key tile, when Sk
//   is ragged, selects -inf for them (full tiles pay nothing).  Query rows
//   past Sq are computed on zeros and not stored.  Each output element is
//   written once, no atomics: two launches give the same bits.
// * bf16, D in {80, 512} (CLIP's 80, the VAE's 512):
//   flash_{packed,headsplit,fwd_lse}_mma_kernel, mma.sync m16n8k16 with no
//   TMA and no pipelining of the loads against the products.  Warps of 16
//   query rows each; q, k, v tiles in shared memory.  d = 512 (the VAE's
//   single head) splits its output columns over 4 warps per row group, each
//   keeping a 16 x 128 f32 accumulator in registers and recomputing the
//   16 x 32 score tile; its tiles take ~100 KB of dynamic shared memory.
//   d = 80 (CLIP) is five 16-wide k-steps.
//   Other bf16 widths, and rows not aligned to 16 bytes, are refused with
//   cudaErrorInvalidValue.
// * f32 (flash_{packed,headsplit,fwd_lse}_kernel), any D up to 512: CUDA-core FMAs, the
//   reference numerics for f32 checks on the card.  256 threads own BQ query
//   rows; TPR = 256 / BQ lanes of a warp share a row, each holding BK / TPR
//   scores and NCOL accumulator columns; row max and sum are butterfly
//   shuffles within the row's lanes.
//     D <= 64:  BQ = 64, BK = 64, NCOL = 16
//     D <= 128: BQ = 64, BK = 64, NCOL = 32
//     D <= 512: BQ = 16, BK = 32, NCOL = 32 (~166 KB of shared memory)
//
// All: keys past Sk (the ragged edge, e.g. 257 CLIP tokens) get zero
// weight; query rows past Sq are computed on zeros and not stored (nor is
// their lse).  The lse costs 4 bytes per row against 2*D*(2 + 2*Sk/Sq) of
// q, k, v and o: it moves neither bound.  Shared
// memory above 48 KB is granted with cudaFuncSetAttribute before each launch,
// and a refused launch is returned as its error code.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;

// which entry point a launch serves: the kernel it runs carries its name
enum Entry { kPacked = 0, kHeadsplit = 1, kFwdLse = 2 };

template <int TPR>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int TPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int BQ, int BK>
size_t smem_bytes(int D) {
  // q [BQ][D+1], k [BK][D+1], v [BK][D], p [BQ][BK+1], all f32
  return sizeof(float) *
         ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
          (size_t)BQ * (BK + 1));
}

#define UNIGEO_F32_PARAMS                                                          \
  const float* __restrict__ q, const float* __restrict__ k,                        \
      const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse, \
      int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss, int64_t v_sb,         \
      int64_t v_ss, int64_t o_sb, int64_t o_ss, int Sq, int Sk, int D, float scale
#define UNIGEO_F32_ARGS \
  q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, Sq, Sk, D, scale

// the body of both f32 kernels; kLse: write the row logsumexp
template <int BQ, int BK, int NCOL, bool kLse>
__device__ __forceinline__ void flash_f32_block(UNIGEO_F32_PARAMS) {
  constexpr int TPR = kThreads / BQ;  // lanes per query row
  constexpr int KPT = BK / TPR;       // scores per lane per key tile
  static_assert(TPR <= 32 && (TPR & (TPR - 1)) == 0, "row group within a warp");
  static_assert(KPT * TPR == BK, "key tile splits evenly over a row group");

  extern __shared__ float smem[];
  const int dq = D + 1;  // padded pitch: rows of a warp fall in distinct banks
  float* qs = smem;                    // [BQ][D+1]
  float* ks = qs + BQ * dq;            // [BK][D+1]
  float* vs = ks + BK * dq;            // [BK][D]
  float* ps = vs + BK * D;             // [BQ][BK+1]

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int lane = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qb = q + b * q_sb + (int64_t)h * D;
  const float* kb = k + b * k_sb + (int64_t)h * D;
  const float* vb = v + b * v_sb + (int64_t)h * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    qs[r * dq + d] = s < Sq ? qb[s * q_ss + d] : 0.f;
  }

  float m_run = -INFINITY, l_run = 0.f;
  float acc[NCOL];
#pragma unroll
  for (int j = 0; j < NCOL; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // previous tile fully consumed (and q tile loaded)
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int s = k0 + r;
      const bool ok = s < Sk;
      ks[r * dq + d] = ok ? kb[s * k_ss + d] : 0.f;
      vs[r * D + d] = ok ? vb[s * v_ss + d] : 0.f;
    }
    __syncthreads();

    float sc[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) sc[j] = 0.f;
    const float* qrow = qs + row * dq;
    for (int d = 0; d < D; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) sc[j] = fmaf(qv, ks[(lane + j * TPR) * dq + d], sc[j]);
    }

    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int key = k0 + lane + j * TPR;
      sc[j] = key < Sk ? sc[j] * scale : -INFINITY;
      tmax = fmaxf(tmax, sc[j]);
    }
    tmax = group_max<TPR>(tmax);
    // every tile holds at least one valid key, so m_new is finite
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = expf(sc[j] - m_new);
      psum += p;
      ps[row * (BK + 1) + lane + j * TPR] = p;
    }
    psum = group_sum<TPR>(psum);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    __syncwarp();  // the row's probabilities were written by lanes of this warp

#pragma unroll
    for (int j = 0; j < NCOL; ++j) acc[j] *= alpha;
    const float* prow = ps + row * (BK + 1);
    for (int kk = 0; kk < BK; ++kk) {
      const float p = prow[kk];
      const float* vrow = vs + kk * D;
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        const int c = lane + j * TPR;
        if (c < D) acc[j] = fmaf(p, vrow[c], acc[j]);
      }
    }
  }

  const int s = q0 + row;
  if (s < Sq) {
    const float l_safe = fmaxf(l_run, 1e-30f);
    const float inv = 1.f / l_safe;
    if (kLse && lane == 0)
      lse[((int64_t)b * gridDim.y + h) * Sq + s] = m_run + logf(l_safe);
    float* orow = o + b * o_sb + s * o_ss + (int64_t)h * D;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int c = lane + j * TPR;
      if (c < D) orow[c] = acc[j] * inv;
    }
  }
}

// one kernel per entry point, so a profile tells them apart by name
template <int BQ, int BK, int NCOL>
__global__ void __launch_bounds__(kThreads) flash_packed_kernel(UNIGEO_F32_PARAMS) {
  flash_f32_block<BQ, BK, NCOL, false>(UNIGEO_F32_ARGS);
}

template <int BQ, int BK, int NCOL>
__global__ void __launch_bounds__(kThreads) flash_headsplit_kernel(UNIGEO_F32_PARAMS) {
  flash_f32_block<BQ, BK, NCOL, false>(UNIGEO_F32_ARGS);
}

template <int BQ, int BK, int NCOL>
__global__ void __launch_bounds__(kThreads) flash_fwd_lse_kernel(UNIGEO_F32_PARAMS) {
  flash_f32_block<BQ, BK, NCOL, true>(UNIGEO_F32_ARGS);
}

template <int BQ, int BK, int NCOL>
cudaError_t launch(Entry entry, const void* q, const void* k, const void* v, void* o,
                   float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                   int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                   int B, int Sq, int Sk, int H, int D, float scale,
                   cudaStream_t stream) {
  auto kern = entry == kFwdLse      ? flash_fwd_lse_kernel<BQ, BK, NCOL>
              : entry == kHeadsplit ? flash_headsplit_kernel<BQ, BK, NCOL>
                                    : flash_packed_kernel<BQ, BK, NCOL>;
  const size_t smem = smem_bytes<BQ, BK>(D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, q_sb, q_ss, k_sb, k_ss,
      v_sb, v_ss, o_sb, o_ss, Sq, Sk, D, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(Entry entry, const void* q, const void* k, const void* v, void* o,
                         float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                         int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                         int B, int Sq, int Sk, int H, int D, float scale,
                         cudaStream_t stream) {
  if (D <= 64)
    return launch<64, 64, 16>(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                              o_sb, o_ss, B, Sq, Sk, H, D, scale, stream);
  if (D <= 128)
    return launch<64, 64, 32>(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                              o_sb, o_ss, B, Sq, Sk, H, D, scale, stream);
  return launch<16, 32, 32>(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                            o_sb, o_ss, B, Sq, Sk, H, D, scale, stream);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path: mma.sync m16n8k16 (bf16 in, f32 accumulate).
// One warp owns 16 query rows; WQ warps stack rows, WD warps split the output
// columns of the same rows (each recomputes the 16 x BK scores, so the d = 512
// accumulator is 128 columns, 64 registers, per warp).  Scores, running max
// and sum stay f32; P is rounded to bf16 for the P.V product, as the Pallas
// kernel does.  Tiles are staged in shared memory with 16-byte loads; rows
// are padded by 8 elements so the fragment loads of a warp hit 32 banks.
// ---------------------------------------------------------------------------

// rows [s0, s0+rows) of a packed head into shared memory (pitch P), zeros
// past S; every row is D contiguous bf16 at 16-byte-aligned addresses
template <int D, int P, int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t ss, int s0, int S, int rows, int tid) {
  constexpr int CH = D / 8;
  for (int i = tid; i < rows * CH; i += NT) {
    const int r = i / CH, c = i % CH, s = s0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) val = *reinterpret_cast<const uint4*>(src + s * ss + c * 8);
    *reinterpret_cast<uint4*>(dst + r * P + c * 8) = val;
  }
}

template <int D, int WQ, int WD, int BK>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(WQ * 16 + 2 * BK) * (D + 8);
}

#define UNIGEO_MMA_PARAMS                                                              \
  const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,            \
      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,              \
      float* __restrict__ lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss, \
      int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss, int Sq, int Sk,           \
      float scale_log2
#define UNIGEO_MMA_ARGS \
  q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, Sq, Sk, scale_log2

// the body of both bf16 kernels; kLse: write the row logsumexp
template <int D, int WQ, int WD, int BK, bool kLse>
__device__ __forceinline__ void flash_mma_block(UNIGEO_MMA_PARAMS) {
  constexpr int NT = WQ * WD * 32;
  constexpr int BQ = WQ * 16;
  constexpr int P = D + 8;    // shared-memory pitch in elements
  constexpr int DW = D / WD;  // output columns per warp
  constexpr int NO = DW / 8;  // output n-tiles per warp
  constexpr int NS = BK / 8;  // score n-tiles
  static_assert(D % 16 == 0 && DW % 8 == 0 && BK % 16 == 0, "tile shapes");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BQ * P;
  __nv_bfloat16* vs = ks + BK * P;
  const unsigned short* vs16 = reinterpret_cast<const unsigned short*>(vs);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wq = warp / WD, wd = warp % WD;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int r0 = wq * 16;

  const __nv_bfloat16* qb = q + b * q_sb + (int64_t)h * D;
  const __nv_bfloat16* kb = k + b * k_sb + (int64_t)h * D;
  const __nv_bfloat16* vb = v + b * v_sb + (int64_t)h * D;

  load_tile<D, P, NT>(qs, qb, q_ss, q0, Sq, BQ, tid);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int t = 0; t < NO; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();
    load_tile<D, P, NT>(ks, kb, k_ss, k0, Sk, BK, tid);
    load_tile<D, P, NT>(vs, vb, v_ss, k0, Sk, BK, tid);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 16) {
      const __nv_bfloat16* qa = qs + (r0 + g) * P + kk + tg * 2;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * P), ld32(qa + 8), ld32(qa + 8 * P + 8)};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const __nv_bfloat16* kp = ks + (j * 8 + g) * P + kk + tg * 2;
        mma_16816(s[j], a, ld32(kp), ld32(kp + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tg * 2 + (e & 1);
        s[j][e] = key < Sk ? s[j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);  // finite: each tile has a valid key
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];  // this lane's share; summed over the quad at the end
      }
    }
#pragma unroll
    for (int t = 0; t < NO; ++t) {
      acc[t][0] *= alpha[0];
      acc[t][1] *= alpha[0];
      acc[t][2] *= alpha[1];
      acc[t][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int j = kk / 8;
      const uint32_t a[4] = {pack_bf16x2(s[j][0], s[j][1]), pack_bf16x2(s[j][2], s[j][3]),
                             pack_bf16x2(s[j + 1][0], s[j + 1][1]),
                             pack_bf16x2(s[j + 1][2], s[j + 1][3])};
#pragma unroll
      for (int t = 0; t < NO; ++t) {
        const unsigned short* vp = vs16 + (kk + tg * 2) * P + wd * DW + t * 8 + g;
        const uint32_t b0 = (uint32_t)vp[0] | ((uint32_t)vp[P] << 16);
        const uint32_t b1 = (uint32_t)vp[8 * P] | ((uint32_t)vp[9 * P] << 16);
        mma_16816(acc[t], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + r0 + g + 8 * i;
    if (s >= Sq) continue;
    // m is in log2 units (scores scaled by scale * log2(e))
    if (kLse && tg == 0 && wd == 0)
      lse[((int64_t)b * gridDim.y + h) * Sq + s] = (m[i] + log2f(l[i])) * 0.6931471805599453f;
    l[i] = 1.f / l[i];
    __nv_bfloat16* orow = o + b * o_sb + s * o_ss + (int64_t)h * D + wd * DW + tg * 2;
#pragma unroll
    for (int t = 0; t < NO; ++t)
      *reinterpret_cast<uint32_t*>(orow + t * 8) =
          pack_bf16x2(acc[t][2 * i] * l[i], acc[t][2 * i + 1] * l[i]);
  }
}

template <int D, int WQ, int WD, int BK>
__global__ void __launch_bounds__(WQ * WD * 32) flash_packed_mma_kernel(UNIGEO_MMA_PARAMS) {
  flash_mma_block<D, WQ, WD, BK, false>(UNIGEO_MMA_ARGS);
}

template <int D, int WQ, int WD, int BK>
__global__ void __launch_bounds__(WQ * WD * 32) flash_headsplit_mma_kernel(UNIGEO_MMA_PARAMS) {
  flash_mma_block<D, WQ, WD, BK, false>(UNIGEO_MMA_ARGS);
}

template <int D, int WQ, int WD, int BK>
__global__ void __launch_bounds__(WQ * WD * 32) flash_fwd_lse_mma_kernel(UNIGEO_MMA_PARAMS) {
  flash_mma_block<D, WQ, WD, BK, true>(UNIGEO_MMA_ARGS);
}

template <int D, int WQ, int WD, int BK>
cudaError_t launch_mma(Entry entry, const void* q, const void* k, const void* v, void* o,
                       float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                       int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                       int B, int Sq, int Sk, int H, float scale, cudaStream_t stream) {
  auto kern = entry == kFwdLse      ? flash_fwd_lse_mma_kernel<D, WQ, WD, BK>
              : entry == kHeadsplit ? flash_headsplit_mma_kernel<D, WQ, WD, BK>
                                    : flash_packed_mma_kernel<D, WQ, WD, BK>;
  constexpr size_t smem = mma_smem_bytes<D, WQ, WD, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + WQ * 16 - 1) / (WQ * 16), H, B);
  kern<<<grid, WQ * WD * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, Sq, Sk,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// 16-byte tile loads need 16-byte-aligned rows: pointers, strides and the
// head offset all multiples of 8 bf16
bool aligned16(const void* q, const void* k, const void* v, const void* o,
               int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
               int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss) {
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
  const int64_t strides = q_sb | q_ss | k_sb | k_ss | v_sb | v_ss | o_sb | o_ss;
  return (ptrs % 16) == 0 && (strides % 8) == 0;
}

// ---------------------------------------------------------------------------
// bf16 at D in {16, 64}: TMA -> mbarrier ring -> wgmma, warp-specialised.
// A block owns kWgConsumers * 64 queries of one (batch, head): a producer
// warpgroup whose one thread issues every TMA load (q once, then k and v
// tiles of 128 keys into a ring of slots under full / empty mbarriers), and
// consumer warpgroups of 64 query rows each.  A consumer runs S = q k^T with
// both operands from shared memory (q by descriptor, never held in
// registers), turns the S accumulator into P's bf16 A registers, and runs
// O += P v with v read MN-major through the transpose bit.  Its loop issues
// S of tile it and P v of tile it - 1 together, then runs tile it's softmax
// while P v runs: the exponentials of one tile overlap the products of the
// other.
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                        // query rows of a consumer
constexpr int kWgConsumers = 3;
constexpr int kWgBlockQ = kWgConsumers * kWgRows;  // queries of a block
constexpr int kWgBlockK = 128;                     // keys of a ring slot
constexpr int kWgStages = 4;
// the consumers take turns to issue their products (named barriers 1 + c),
// so one's softmax runs under another's products
constexpr bool kWgPingpong = true;
constexpr int kWgThreads = 128 * (kWgConsumers + 1);
constexpr int kWgProducerRegs = 24;
// the registers the producer gives up, shared among the consumers
constexpr int kWgConsumerRegs = (65536 - 128 * kWgProducerRegs) / (128 * kWgConsumers) / 8 * 8;
static_assert(kWgConsumers == 2 || kWgConsumers == 3, "two or three consumers");
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A slot holds v before k: a descriptor that misreads v, as the planted
// transpose-bit fault of tests/test_torch_cuda.py does, still reads inside
// the slot.
template <int D>
struct WgSmem {
  struct Slot {
    __nv_bfloat16 v[kWgBlockK * D];
    __nv_bfloat16 k[kWgBlockK * D];
  };
  __nv_bfloat16 q[kWgBlockQ * D];  // consumer c's rows at q + c * 64 * D
  Slot slot[kWgStages];
  uint64_t q_full, full[kWgStages], empty[kWgStages];
};

// 2^x by the SFU (ex2.approx.ftz: 2 ulp, results below 2^-126 flushed to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = q k^T of one consumer's 64 rows and a slot's BK keys (the first
// k-step overwrites s)
template <int D, int BK>
__device__ __forceinline__ void issue_scores(float (&s)[BK / 2], const __nv_bfloat16* qs,
                                             const __nv_bfloat16* ks) {
  using Tile = sm90::SwizzledTile<D>;
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    if constexpr (BK == 128)
      sm90::wgmma_ss128(s, Tile::kmajor(qs, i), Tile::kmajor(ks, i), i);
    else
      sm90::wgmma_ss64<0, 0>(s, Tile::kmajor(qs, i), Tile::kmajor(ks, i), i);
  }
  sm90::wgmma_commit();
}

// O += P v: A = P's registers, B = the slot's v read MN-major
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[kWgBlockK / 16][4],
                                         const __nv_bfloat16* vs) {
  using Tile = sm90::SwizzledTile<D>;
#pragma unroll
  for (int i = 0; i < kWgBlockK / 16; ++i)
    sm90::wgmma_rs<D, 1>(o, pa[i], Tile::mnmajor(vs, i), 1);
  sm90::wgmma_commit();
}

// One key tile of the online softmax for this thread's two rows (g and
// g + 8 of its warp's 16).  Element 4j + e of s is the score of row
// g + 8 (e >> 1) and key 8j + 2tg + (e & 1) of the tile.  m is the running
// max in log2 units (scores times scale * log2(e)), l this thread's share
// of the row sums.  s becomes p = 2^(s * scale_log2 - m); returns
// alpha = 2^(m_old - m_new) per row.  kMask (the last tile, when Sk is
// ragged): keys with 8j + (e & 1) >= lim score -inf, since the TMA's zero
// key rows would otherwise score 0.
template <bool kMask>
__device__ __forceinline__ float2 softmax_tile(float (&s)[kWgBlockK / 2], float (&m)[2],
                                               float (&l)[2], float scale_log2, int lim) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kWgBlockK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMask) s[4 * j + e] = 8 * j + (e & 1) < lim ? s[4 * j + e] : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * scale_log2);  // finite: each tile has a key
    alpha[i] = exp2_approx(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < kWgBlockK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], scale_log2, -m[e >> 1]));
      l[e >> 1] += s[4 * j + e];
    }
  return make_float2(alpha[0], alpha[1]);
}

// p (f32, the S accumulator's layout) -> the bf16 A registers of P v's
// k-steps: k-step i takes the tile's keys [16i, 16i + 16)
__device__ __forceinline__ void p_to_a(uint32_t (&pa)[kWgBlockK / 16][4],
                                       const float (&p)[kWgBlockK / 2]) {
#pragma unroll
  for (int i = 0; i < kWgBlockK / 16; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[i][r] = pack_bf16x2(p[8 * i + 2 * r], p[8 * i + 2 * r + 1]);
}

#define UNIGEO_WG_PARAMS                                                            \
  const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k, \
      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,          \
      float* __restrict__ lse, int Sq, int Sk, float scale_log2
#define UNIGEO_WG_ARGS tm_q, tm_k, tm_v, o, lse, Sq, Sk, scale_log2

// the body of the three wgmma kernels; kLse: write the row logsumexp
template <int D, bool kLse>
__device__ __forceinline__ void flash_wgmma_block(const CUtensorMap& tm_q,
                                                  const CUtensorMap& tm_k,
                                                  const CUtensorMap& tm_v,
                                                  __nv_bfloat16* __restrict__ o,
                                                  float* __restrict__ lse, int Sq, int Sk,
                                                  float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WgSmem<D>& sm = sm90::aligned_smem<WgSmem<D>>(smem_raw);
  const int q0 = blockIdx.x * kWgBlockQ, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int n_tiles = (Sk + kWgBlockK - 1) / kWgBlockK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kWgStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      sm90::mbar_init(&sm.empty[s], 4 * kWgConsumers);  // one arrival per consumer warp
    }
    sm90::mbar_init(&sm.q_full, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every TMA load
    sm90::setmaxnreg_dec<kWgProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(&sm.q_full, kWgBlockQ * D * sizeof(__nv_bfloat16));
      sm90::tma_load_3d(sm.q, &tm_q, &sm.q_full, h * D, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kWgStages;
        sm90::mbar_wait(&sm.empty[s], ((it / kWgStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * kWgBlockK * D * sizeof(__nv_bfloat16));
        sm90::tma_load_3d(sm.slot[s].k, &tm_k, &sm.full[s], h * D, it * kWgBlockK, b);
        sm90::tma_load_3d(sm.slot[s].v, &tm_v, &sm.full[s], h * D, it * kWgBlockK, b);
      }
    }
    return;
  }

  // consumer c: queries [q0 + 64c, q0 + 64c + 64)
  sm90::setmaxnreg_inc<kWgConsumerRegs>();
  const int c = wg - 1, w = (threadIdx.x / 32) % 4, g = lane / 4, tg = lane % 4;
  const __nv_bfloat16* qs = sm.q + c * kWgRows * D;
  const int last = n_tiles - 1;
  const bool ragged = Sk % kWgBlockK != 0;
  const int lim = Sk - last * kWgBlockK - 2 * tg;  // the last tile's mask bound
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[kWgBlockK / 2];
  uint32_t pa[kWgBlockK / 16][4];
  // the consumers' turns, in the order 0, 1, ...: c issues between a sync
  // on its barrier (1 + c) and an arrival on the next one's; consumer 0
  // goes first, and the last consumer's last turn passes nothing on, so
  // every arrival is consumed
  const int next = 1 + (c + 1) % kWgConsumers;
  const auto turn = [&] {
    if constexpr (kWgPingpong) sm90::bar_sync<2 * 128>(1 + c);
  };
  const auto pass = [&](bool more) {
    if constexpr (kWgPingpong)
      if (more) sm90::bar_arrive<2 * 128>(next);
  };
  if (kWgPingpong && c == kWgConsumers - 1) sm90::bar_arrive<2 * 128>(1);
  sm90::mbar_wait(&sm.q_full, 0);

  // tile 0: S, its softmax, P
  sm90::mbar_wait(&sm.full[0], 0);
  turn();
  sm90::wgmma_fence();
  issue_scores<D, kWgBlockK>(s, qs, sm.slot[0].k);
  pass(true);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  if (ragged && last == 0)
    softmax_tile<true>(s, m, l, scale_log2, lim);
  else
    softmax_tile<false>(s, m, l, scale_log2, lim);
  p_to_a(pa, s);

  for (int it = 1; it < n_tiles; ++it) {
    const int sl = it % kWgStages, prev = (it - 1) % kWgStages;
    sm90::mbar_wait(&sm.full[sl], (it / kWgStages) & 1);
    // S(it), and O += P(it - 1) v(it - 1) behind it
    sm90::fence_regs(pa);
    sm90::fence_regs(acc);
    turn();
    sm90::wgmma_fence();
    issue_scores<D, kWgBlockK>(s, qs, sm.slot[sl].k);
    issue_pv<D>(acc, pa, sm.slot[prev].v);
    pass(true);
    sm90::wgmma_wait<1>();
    sm90::fence_regs(s);
    // tile it's softmax while P(it - 1) v(it - 1) runs
    const float2 alpha = ragged && it == last ? softmax_tile<true>(s, m, l, scale_log2, lim)
                                              : softmax_tile<false>(s, m, l, scale_log2, lim);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_regs(pa);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&sm.empty[prev]);  // slot it - 1 is free
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha.x;
      acc[4 * j + 1] *= alpha.x;
      acc[4 * j + 2] *= alpha.y;
      acc[4 * j + 3] *= alpha.y;
    }
    p_to_a(pa, s);
  }

  // O += P(last) v(last)
  sm90::fence_regs(pa);
  sm90::fence_regs(acc);
  turn();
  sm90::wgmma_fence();
  issue_pv<D>(acc, pa, sm.slot[last % kWgStages].v);
  pass(c != kWgConsumers - 1);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  // O / l into the packed rows (and lse = (m + log2 l) ln 2); rows past Sq,
  // computed on the TMA's zero rows, are not stored
  const int64_t hd = (int64_t)H * D;
  const int64_t lse_bh = ((int64_t)b * H + h) * Sq;
  const int row0 = q0 + c * kWgRows + 16 * w + g;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
    if (kLse && tg == 0) lse[lse_bh + row] = (m[i] + log2f(l[i])) * kLn2;
    const float inv = 1.f / l[i];
    __nv_bfloat16* orow = o + ((int64_t)b * Sq + row) * hd + (int64_t)h * D + 2 * tg;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16x2(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1) flash_packed_wgmma_kernel(UNIGEO_WG_PARAMS) {
  flash_wgmma_block<D, false>(UNIGEO_WG_ARGS);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1) flash_headsplit_wgmma_kernel(UNIGEO_WG_PARAMS) {
  flash_wgmma_block<D, false>(UNIGEO_WG_ARGS);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1) flash_fwd_lse_wgmma_kernel(UNIGEO_WG_PARAMS) {
  flash_wgmma_block<D, true>(UNIGEO_WG_ARGS);
}

// q, k, v and o must be contiguous [B, S, H*D] (the tensor maps and the
// stores assume it); anything else is refused
template <int D>
cudaError_t launch_wgmma(Entry entry, const void* q, const void* k, const void* v, void* o,
                         float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                         int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                         int B, int Sq, int Sk, int H, float scale, cudaStream_t stream) {
  const int64_t hd = (int64_t)H * D;
  if (q_ss != hd || k_ss != hd || v_ss != hd || o_ss != hd || q_sb != Sq * hd ||
      o_sb != Sq * hd || k_sb != Sk * hd || v_sb != Sk * hd)
    return cudaErrorInvalidValue;
  constexpr CUtensorMapSwizzle swz = D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = sm90::packed_tile_map(&tq, q, B, Sq, (int)hd, D, kWgBlockQ, swz)) != cudaSuccess ||
      (err = sm90::packed_tile_map(&tk, k, B, Sk, (int)hd, D, kWgBlockK, swz)) != cudaSuccess ||
      (err = sm90::packed_tile_map(&tv, v, B, Sk, (int)hd, D, kWgBlockK, swz)) != cudaSuccess)
    return err;
  auto kern = entry == kFwdLse      ? flash_fwd_lse_wgmma_kernel<D>
              : entry == kHeadsplit ? flash_headsplit_wgmma_kernel<D>
                                    : flash_packed_wgmma_kernel<D>;
  constexpr size_t smem = sizeof(WgSmem<D>) + 1024;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kWgBlockQ - 1) / kWgBlockQ, H, B);
  kern<<<grid, kWgThreads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse,
                                           Sq, Sk, scale * kLog2e);
  return cudaGetLastError();
}

// The bf16 forward's one switch by head width: the wgmma body at the UNet's
// 64 (and 16 for small checks), the mma.sync body at CLIP's 80 and the VAE's
// 512.  A launch either body refuses returns its error: no other body is
// tried.
cudaError_t dispatch_bf16(Entry entry, const void* q, const void* k, const void* v, void* o,
                          float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                          int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                          int B, int Sq, int Sk, int H, int D, float scale,
                          cudaStream_t stream) {
  if (!aligned16(q, k, v, o, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss))
    return cudaErrorInvalidValue;
#define UNIGEO_WG(DD)                                                                    \
  case DD:                                                                               \
    return launch_wgmma<DD>(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,  \
                            o_sb, o_ss, B, Sq, Sk, H, scale, stream);
#define UNIGEO_MMA(DD, WQ, WD, BK)                                                   \
  case DD:                                                                           \
    return launch_mma<DD, WQ, WD, BK>(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, \
                                      v_ss, o_sb, o_ss, B, Sq, Sk, H, scale, stream);
  switch (D) {
    UNIGEO_WG(16)
    UNIGEO_WG(64)
    UNIGEO_MMA(80, 4, 1, 64)
    UNIGEO_MMA(512, 2, 4, 32)
    default:
      return cudaErrorInvalidValue;
  }
#undef UNIGEO_MMA
#undef UNIGEO_WG
}

}  // namespace

namespace {

cudaError_t dispatch(Entry entry, const void* q, const void* k, const void* v, void* o,
                     float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                     int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                     int B, int Sq, int Sk, int H, int D, float scale, int dtype,
                     void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || D <= 0 || D > 512 || H > 65535 ||
      B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_f32(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                        o_sb, o_ss, B, Sq, Sk, H, D, scale, st);
  if (dtype == 1)
    return dispatch_bf16(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb,
                         o_ss, B, Sq, Sk, H, D, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements: *_sb between
// batch entries, *_ss between sequence positions; the packed row is
// contiguous.  Returns the launch's cudaError_t (0 on success).
extern "C" int unigeo_flash_attention_packed(
    const void* q, const void* k, const void* v, void* o,
    int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
    int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
    int B, int Sq, int Sk, int H, int D, float scale, int dtype,
    void* stream) {
  return (int)dispatch(kPacked, q, k, v, o, nullptr, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                       o_sb, o_ss, B, Sq, Sk, H, D, scale, dtype, stream);
}

// The same function for q, k, v, o viewed as [B, S, H, D] (contiguous, so
// the packed strides apply), launched as the flash_headsplit_* kernels.
extern "C" int unigeo_flash_attention_headsplit(
    const void* q, const void* k, const void* v, void* o,
    int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
    int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
    int B, int Sq, int Sk, int H, int D, float scale, int dtype,
    void* stream) {
  return (int)dispatch(kHeadsplit, q, k, v, o, nullptr, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                       o_sb, o_ss, B, Sq, Sk, H, D, scale, dtype, stream);
}

// The same, and lse [B, H, Sq] f32 (contiguous) of the natural-log row sums.
extern "C" int unigeo_flash_attention_fwd_lse(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
    int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
    int B, int Sq, int Sk, int H, int D, float scale, int dtype,
    void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return (int)dispatch(kFwdLse, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                       o_sb, o_ss, B, Sq, Sk, H, D, scale, dtype, stream);
}

extern "C" const char* unigeo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
