// Packed flash-attention forward for Hopper (sm_90a).
//
// Replaces: unigeo_tpu/ops/attention.py::flash_attention_tpu_packed
// (Pallas kernel _flash_packed_kernel).  It computes, for every batch b and
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
// What this design does about it: the S x S score matrix never reaches
// device memory (online softmax with an f32 running max, sum and
// accumulator, one key tile at a time in shared memory), and in bf16 both
// products run on the tensor cores (mma.sync m16n8k16, f32 accumulate).
// This is the simple form of that design: no TMA, no wgmma, no pipelining of
// the tile loads against the products, so it reaches a fraction of the
// bound; those are later work.
//
// One block layout per dtype:
//
// * bf16 (flash_packed_mma_kernel), D in {16, 64, 80, 512} (the UNet's 64,
//   CLIP's 80, the VAE's 512, and 16 for small checks) with 16-byte-aligned
//   rows; anything else is refused with cudaErrorInvalidValue.  Warps of 16
//   query rows each; q, k, v tiles in shared memory; scores and P.V through
//   mma.sync.  d = 512 (the VAE's single head) splits its output columns
//   over 4 warps per row group, each keeping a 16 x 128 f32 accumulator in
//   registers and recomputing the 16 x 32 score tile; its tiles take
//   ~100 KB of dynamic shared memory.  d = 80 (CLIP) is five 16-wide k-steps.
// * f32 (flash_packed_kernel), any D up to 512: CUDA-core FMAs, the
//   reference numerics for f32 checks on the card.  256 threads own BQ query
//   rows; TPR = 256 / BQ lanes of a warp share a row, each holding BK / TPR
//   scores and NCOL accumulator columns; row max and sum are butterfly
//   shuffles within the row's lanes.
//     D <= 64:  BQ = 64, BK = 64, NCOL = 16
//     D <= 128: BQ = 64, BK = 64, NCOL = 32
//     D <= 512: BQ = 16, BK = 32, NCOL = 32 (~166 KB of shared memory)
//
// Both: keys past Sk (the ragged edge, e.g. 257 CLIP tokens) get zero
// weight; query rows past Sq are computed on zeros and not stored.  Shared
// memory above 48 KB is granted with cudaFuncSetAttribute before each launch,
// and a refused launch is returned as its error code.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <int BQ, int BK, int NCOL>
__global__ void __launch_bounds__(kThreads)
flash_packed_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                    int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                    int Sq, int Sk, int D, float scale) {
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
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    float* orow = o + b * o_sb + s * o_ss + (int64_t)h * D;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int c = lane + j * TPR;
      if (c < D) orow[c] = acc[j] * inv;
    }
  }
}

template <int BQ, int BK, int NCOL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                   int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                   int B, int Sq, int Sk, int H, int D, float scale,
                   cudaStream_t stream) {
  auto kern = flash_packed_kernel<BQ, BK, NCOL>;
  const size_t smem = smem_bytes<BQ, BK>(D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), q_sb, q_ss, k_sb, k_ss,
      v_sb, v_ss, o_sb, o_ss, Sq, Sk, D, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o,
                     int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                     int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                     int B, int Sq, int Sk, int H, int D, float scale,
                     cudaStream_t stream) {
  if (D <= 64)
    return launch<64, 64, 16>(q, k, v, o, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                              o_sb, o_ss, B, Sq, Sk, H, D, scale, stream);
  if (D <= 128)
    return launch<64, 64, 32>(q, k, v, o, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                              o_sb, o_ss, B, Sq, Sk, H, D, scale, stream);
  return launch<16, 32, 32>(q, k, v, o, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
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

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

template <int D, int WQ, int WD, int BK>
__global__ void __launch_bounds__(WQ * WD * 32)
flash_packed_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o,
                        int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                        int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                        int Sq, int Sk, float scale_log2) {
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
    l[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + r0 + g + 8 * i;
    if (s >= Sq) continue;
    __nv_bfloat16* orow = o + b * o_sb + s * o_ss + (int64_t)h * D + wd * DW + tg * 2;
#pragma unroll
    for (int t = 0; t < NO; ++t)
      *reinterpret_cast<uint32_t*>(orow + t * 8) =
          pack_bf16x2(acc[t][2 * i] * l[i], acc[t][2 * i + 1] * l[i]);
  }
}

template <int D, int WQ, int WD, int BK>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                       int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                       int B, int Sq, int Sk, int H, float scale, cudaStream_t stream) {
  auto kern = flash_packed_mma_kernel<D, WQ, WD, BK>;
  constexpr size_t smem = mma_smem_bytes<D, WQ, WD, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + WQ * 16 - 1) / (WQ * 16), H, B);
  kern<<<grid, WQ * WD * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
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

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                          int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                          int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                          int B, int Sq, int Sk, int H, int D, float scale,
                          cudaStream_t stream) {
  if (!aligned16(q, k, v, o, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss))
    return cudaErrorInvalidValue;
#define UNIGEO_MMA(DD, WQ, WD, BK)                                                   \
  case DD:                                                                           \
    return launch_mma<DD, WQ, WD, BK>(q, k, v, o, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, \
                                      o_sb, o_ss, B, Sq, Sk, H, scale, stream);
  switch (D) {
    UNIGEO_MMA(16, 4, 1, 64)
    UNIGEO_MMA(64, 4, 1, 64)
    UNIGEO_MMA(80, 4, 1, 64)
    UNIGEO_MMA(512, 2, 4, 32)
    default:
      return cudaErrorInvalidValue;
  }
#undef UNIGEO_MMA
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
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || D <= 0 || D > 512 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_f32(q, k, v, o, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                             o_sb, o_ss, B, Sq, Sk, H, D, scale, st);
  if (dtype == 1)
    return (int)dispatch_bf16(q, k, v, o, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb,
                              o_ss, B, Sq, Sk, H, D, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* unigeo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
