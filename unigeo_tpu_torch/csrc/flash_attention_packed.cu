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
// bound is the operations at the UNet's and the VAE's shapes, the bytes at
// CLIP's 257 tokens (Sq*Sk/(Sq+Sk) = 128 operations per byte).
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
// Six block layouts, chosen by dtype, head width and alignment, one switch
// per dtype (dispatch_bf16, dispatch_f32); the bf16 bodies at the main
// path's widths are Hopper's TMA and wgmma (blocks from sm90.cuh):
//
// * bf16, D in {16, 64, 80} (the UNet's 64, CLIP's 80, and 16 for small
//   checks): flash_{packed,headsplit,fwd_lse}_wgmma_kernel<D>.  At most one
//   block per SM walks over items of 192 queries of one (batch, head): a
//   producer warpgroup (setmaxnreg 24) whose one thread loads each item's q
//   (two buffers, so the next item's q arrives while this one finishes) and
//   keeps a 4-slot ring of k and v tiles full across items under full /
//   empty mbarriers (3-D tensor maps over the packed layout; a row is one
//   64-column box with the 128-byte swizzle at D = 64,
//   one 16-column box with the 32-byte swizzle at D = 16, and five of those
//   at D = 80, whose 160 bytes are wider than the 128-byte swizzle span),
//   and three consumer warpgroups (160 registers) of 64 query rows.  S =
//   q k^T is an m64nBK wgmma with both operands from shared memory (q is
//   never held in registers), one k-step per 16 columns; P goes from the S
//   accumulator into bf16 A registers for O += P v, one m64nD wgmma per 16
//   keys whose B is the v tile read MN-major (the transpose bit; at D = 80
//   its five boxes are the atoms along N, a box apart).  Each consumer
//   issues S of tile it with P v of tile it - 1 and runs tile it's softmax
//   (one ex2.approx.ftz per score, the scale folded into log2 units) while
//   P v runs; the consumers take turns to issue (named barriers), so one's
//   softmax runs under another's products.  Key tiles are 128 keys at D 16
//   and 64, 64 at D = 80 (CLIP's 257 tokens: five tiles, the last of one
//   key, in place of three of 128).  Three consumers rather than two (three
//   warps a scheduler to hide the softmax's latencies), the turns, the
//   4-slot ring, the key tiles and the walk over items are the measured
//   choices of unigeo_tpu_torch/tools/forward_variants.py.
//   The TMA returns zero rows past Sk, which would score 0, not -inf: the
//   last key tile, when Sk is ragged, selects -inf for them (full tiles pay
//   nothing).  Query rows past Sq are computed on zeros and not stored.
// * bf16, D = 512 (the VAE mid block's one head):
//   flash_{packed,headsplit,fwd_lse}_wgmma512_kernel.  A 64-row f32
//   accumulator over 512 columns would take 256 registers a thread of one
//   warpgroup, so a block owns 64 query rows and its two consumer
//   warpgroups (240 registers) split the output columns, 256 each; each
//   computes its half of the d-sum of S (sixteen m64n32 k-steps from shared
//   memory), the two trade the partial S through shared memory at a named
//   barrier and both run the same softmax on S = S_0 + S_1, then
//   O_c += P v[:, half c] is an m64n256 wgmma with v MN-major.  q (64 KB)
//   is loaded once; k and v tiles of 32 keys have rings of their own (two
//   slots each, 224 KB in all with q and the trade's buffers), so a k slot
//   is freed as soon as its S is taken and a v slot after its P v.  Each
//   64-row block fetches every key's 2 KB of k and v from L2.
//   Every bf16 body writes each output element once, no atomics: two
//   launches give the same bits.  Rows not contiguous [B, S, H*D] are
//   refused with cudaErrorInvalidValue.
// * bf16, any other D (the tiny pointmap configs' 24 and 32, the checks' 8
//   and 128), and rows not aligned to 16 bytes at any width (the TMA cannot
//   take them): the CUDA-core body below instantiated for bf16,
//   flash_{packed,headsplit,fwd_lse}_kernel<__nv_bfloat16, BQ, BK, NCOL>, and
//   past D = 512 its column-chunked form flash_*_wide_kernel<__nv_bfloat16>.
//   It reads bf16 into f32 and does every product and sum in f32 (P is not
//   rounded to bf16, as the wgmma bodies round it); the output is rounded
//   to bf16 once, lse stays f32.  No shape reaches it on a default path
//   (the models' bf16 widths are 64, 80 and 512, their rows aligned).
// * f32, D = 64 (Spann3R's and UniGeoCam's pointmap path):
//   flash_{packed,headsplit,fwd_lse}_f32reg_kernel<kWarps, kStages, kSplit>,
//   register-tiled FMAs on the CUDA cores fed by a cp.async ring
//   (see its section below).  The f32 work is 4*B*H*Sq*Sk*D operations at
//   the CUDA cores' 67 TF/s against 4*B*H*D*(2*Sq + 2*Sk) bytes: at Sq = Sk
//   = 768 (768 tokens of a 384 x 512 frame) 192 operations per byte, far
//   above the 20 at which the FMA units rather than memory bound it.  What
//   held the earlier body to 15% of that rate was shared memory: one load
//   per FMA.  This body loads 16 bytes for 10.7 FMAs.  Rows must be aligned
//   to 16 bytes (else the launch is refused).
// * f32, D = 512 (the DepthCrafter trainer's f32 target encode, the VAE mid
//   block's one head): flash_{packed,headsplit,fwd_lse}_f32w512_kernel<kBK>,
//   register-tiled FMAs on the CUDA cores fed by the TMA (see its section
//   below): 64-row items whose 8 warps each own a 64-wide slice of d, trade
//   partial scores through shared memory and split the softmax's rows.
//   Rows must be aligned to 16 bytes (else the launch is refused).
// * f32, any other D (the checks' 8, 10, 32 and 80, the tiny
//   pointmap configs' 24 and 32): flash_{packed,headsplit,fwd_lse}_kernel
//   <float, BQ, BK, NCOL>, CUDA-core FMAs (the same body as bf16's above).  256 threads own BQ query rows; TPR = 256 / BQ lanes of
//   a warp share a row, each holding BK / TPR scores and NCOL accumulator
//   columns; row max and sum are butterfly shuffles within the row's lanes.
//     D <= 64:  BQ = 64, BK = 64, NCOL = 16
//     D <= 128: BQ = 64, BK = 64, NCOL = 32
//     D <= 512: BQ = 16, BK = 32, NCOL = 32 (~166 KB of shared memory)
//     D > 512:  the same layout with the head width streamed in column
//               chunks of at most 512, flash_{packed,headsplit,fwd_lse}
//               _wide_kernel<T> (see its section below; bf16 too)
//   Every f32 body is exact f32 (no TF32 anywhere): the reference numerics
//   for f32 checks on the card.
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

// the CUDA-core body's element type T: float, or __nv_bfloat16 read into f32
// on load and rounded to bf16 once on the store
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

#define UNIGEO_F32_PARAMS                                                          \
  const float* __restrict__ q, const float* __restrict__ k,                        \
      const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse, \
      int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss, int64_t v_sb,         \
      int64_t v_ss, int64_t o_sb, int64_t o_ss, int Sq, int Sk, int D, float scale
// the CUDA-core body's: its element type T for q, k, v and o
#define UNIGEO_CC_PARAMS                                                           \
  const T* __restrict__ q, const T* __restrict__ k,                                \
      const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,         \
      int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss, int64_t v_sb,         \
      int64_t v_ss, int64_t o_sb, int64_t o_ss, int Sq, int Sk, int D, float scale
#define UNIGEO_F32_ARGS \
  q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, Sq, Sk, D, scale

// the body of the CUDA-core kernels; kLse: write the row logsumexp.  T =
// float, or __nv_bfloat16 (read into f32 on load; every score, sum and
// product in f32, the output rounded to bf16 once, lse kept f32)
template <typename T, int BQ, int BK, int NCOL, bool kLse>
__device__ __forceinline__ void flash_f32_block(UNIGEO_CC_PARAMS) {
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

  const T* qb = q + b * q_sb + (int64_t)h * D;
  const T* kb = k + b * k_sb + (int64_t)h * D;
  const T* vb = v + b * v_sb + (int64_t)h * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    qs[r * dq + d] = s < Sq ? to_f32(qb[s * q_ss + d]) : 0.f;
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
      ks[r * dq + d] = ok ? to_f32(kb[s * k_ss + d]) : 0.f;
      vs[r * D + d] = ok ? to_f32(vb[s * v_ss + d]) : 0.f;
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
    T* orow = o + b * o_sb + s * o_ss + (int64_t)h * D;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int c = lane + j * TPR;
      if (c < D) orow[c] = from_f32<T>(acc[j] * inv);
    }
  }
}

// one kernel per entry point, so a profile tells them apart by name (and
// by T: flash_packed_kernel<float, ...> or <__nv_bfloat16, ...>)
template <typename T, int BQ, int BK, int NCOL>
__global__ void __launch_bounds__(kThreads) flash_packed_kernel(UNIGEO_CC_PARAMS) {
  flash_f32_block<T, BQ, BK, NCOL, false>(UNIGEO_F32_ARGS);
}

template <typename T, int BQ, int BK, int NCOL>
__global__ void __launch_bounds__(kThreads) flash_headsplit_kernel(UNIGEO_CC_PARAMS) {
  flash_f32_block<T, BQ, BK, NCOL, false>(UNIGEO_F32_ARGS);
}

template <typename T, int BQ, int BK, int NCOL>
__global__ void __launch_bounds__(kThreads) flash_fwd_lse_kernel(UNIGEO_CC_PARAMS) {
  flash_f32_block<T, BQ, BK, NCOL, true>(UNIGEO_F32_ARGS);
}

template <typename T, int BQ, int BK, int NCOL>
cudaError_t launch(Entry entry, const void* q, const void* k, const void* v, void* o,
                   float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                   int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                   int B, int Sq, int Sk, int H, int D, float scale,
                   cudaStream_t stream) {
  auto kern = entry == kFwdLse      ? flash_fwd_lse_kernel<T, BQ, BK, NCOL>
              : entry == kHeadsplit ? flash_headsplit_kernel<T, BQ, BK, NCOL>
                                    : flash_packed_kernel<T, BQ, BK, NCOL>;
  const size_t smem = smem_bytes<BQ, BK>(D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, Sq, Sk, D,
      scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head widths past 512, both dtypes, any alignment:
// flash_{packed,headsplit,fwd_lse}_wide_kernel<T>.  The d <= 512 layout
// (16 query rows, 16 lanes a row, 32-key tiles, 32 accumulator columns a
// lane) with the head width streamed in column chunks of at most 512, so
// shared memory does not grow with D: the head splits into
// ceil(D / 512) chunks as equal as can be (wide_chunk), a block owns one
// chunk of the output columns of its 16 rows, and each key tile's scores
// are summed over every chunk of q and k in turn (the d-sum in the order
// d = 0 .. D-1, as the other CUDA-core bodies take it).  So the blocks of
// one row block recompute the same scores, once per output chunk: at
// D = 1024 twice the score work.  Reads every element into f32, does every
// score, sum and product in f32 (P is not rounded), rounds the output once;
// lse is written by the first chunk's block.  No default path reaches it
// (the models' widths are 512 and below); it exists so that no width
// raises, as the JAX kernels take any width.
// ---------------------------------------------------------------------------

constexpr int kWideRows = 16, kWideKeys = 32, kWideCols = 32;
constexpr int kWideMaxChunk = (kThreads / kWideRows) * kWideCols;  // 512

// the column chunk of a head of width D: ceil(D / 512) chunks, as equal as
// can be (520 -> 260, 768 -> 384, 1024 -> 512)
__host__ __device__ __forceinline__ int wide_chunk(int D) {
  const int n = (D + kWideMaxChunk - 1) / kWideMaxChunk;
  return (D + n - 1) / n;
}

size_t wide_smem_bytes(int DC) {
  // q [16][DC+1], k [32][DC+1], v [32][DC], p [16][33], all f32
  return sizeof(float) * ((size_t)kWideRows * (DC + 1) + (size_t)kWideKeys * (DC + 1) +
                          (size_t)kWideKeys * DC + (size_t)kWideRows * (kWideKeys + 1));
}

// rows [s0, s0 + R) and columns [c0, c0 + cw) of a head into shared memory
// (pitch ld), in f32, zero past S
template <typename T, int R>
__device__ __forceinline__ void load_chunk(float* dst, int ld, const T* src, int64_t ss,
                                           int s0, int S, int c0, int cw) {
  for (int i = threadIdx.x; i < R * cw; i += kThreads) {
    const int r = i / cw, c = i % cw, s = s0 + r;
    dst[r * ld + c] = s < S ? to_f32(src[(int64_t)s * ss + c0 + c]) : 0.f;
  }
}

template <typename T, bool kLse>
__device__ __forceinline__ void flash_wide_block(UNIGEO_CC_PARAMS) {
  constexpr int BQ = kWideRows, BK = kWideKeys, NCOL = kWideCols;
  constexpr int TPR = kThreads / BQ;  // 16 lanes a row
  constexpr int KPT = BK / TPR;       // 2 scores a lane

  extern __shared__ float smem[];
  const int DC = wide_chunk(D), cp = DC + 1;
  const int n_chunks = (D + DC - 1) / DC;
  float* qs = smem;              // [BQ][DC+1]
  float* ks = qs + BQ * cp;      // [BK][DC+1]
  float* vs = ks + BK * cp;      // [BK][DC]
  float* ps = vs + BK * DC;      // [BQ][BK+1]

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int lane = tid % TPR;
  const int oc = blockIdx.x % n_chunks;  // this block's output chunk
  const int q0 = blockIdx.x / n_chunks * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int o0 = oc * DC, ow = min(DC, D - o0);

  const T* qb = q + b * q_sb + (int64_t)h * D;
  const T* kb = k + b * k_sb + (int64_t)h * D;
  const T* vb = v + b * v_sb + (int64_t)h * D;

  float m_run = -INFINITY, l_run = 0.f;
  float acc[NCOL];
#pragma unroll
  for (int j = 0; j < NCOL; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    float sc[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) sc[j] = 0.f;
    // the scores: the d-sum over every column chunk of q and k
    for (int c0 = 0; c0 < D; c0 += DC) {
      const int cw = min(DC, D - c0);
      __syncthreads();  // the chunk before (and the tile before's P v) consumed
      load_chunk<T, BQ>(qs, cp, qb, q_ss, q0, Sq, c0, cw);
      load_chunk<T, BK>(ks, cp, kb, k_ss, k0, Sk, c0, cw);
      __syncthreads();
      const float* qrow = qs + row * cp;
      for (int d = 0; d < cw; ++d) {
        const float qv = qrow[d];
#pragma unroll
        for (int j = 0; j < KPT; ++j) sc[j] = fmaf(qv, ks[(lane + j * TPR) * cp + d], sc[j]);
      }
    }

    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int key = k0 + lane + j * TPR;
      sc[j] = key < Sk ? sc[j] * scale : -INFINITY;
      tmax = fmaxf(tmax, sc[j]);
    }
    tmax = group_max<TPR>(tmax);  // over the row's 16 lanes
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

    // this block's output chunk of the tile's v rows
    load_chunk<T, BK>(vs, DC, vb, v_ss, k0, Sk, o0, ow);
    __syncthreads();  // v's chunk loaded (and the rows' P written)

#pragma unroll
    for (int j = 0; j < NCOL; ++j) acc[j] *= alpha;
    const float* prow = ps + row * (BK + 1);
    for (int kk = 0; kk < BK; ++kk) {
      const float p = prow[kk];
      const float* vrow = vs + kk * DC;
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        const int c = lane + j * TPR;
        if (c < ow) acc[j] = fmaf(p, vrow[c], acc[j]);
      }
    }
  }

  const int s = q0 + row;
  if (s < Sq) {
    const float l_safe = fmaxf(l_run, 1e-30f);
    const float inv = 1.f / l_safe;
    if (kLse && oc == 0 && lane == 0)
      lse[((int64_t)b * gridDim.y + h) * Sq + s] = m_run + logf(l_safe);
    T* orow = o + b * o_sb + s * o_ss + (int64_t)h * D + o0;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int c = lane + j * TPR;
      if (c < ow) orow[c] = from_f32<T>(acc[j] * inv);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_packed_wide_kernel(UNIGEO_CC_PARAMS) {
  flash_wide_block<T, false>(UNIGEO_F32_ARGS);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_headsplit_wide_kernel(UNIGEO_CC_PARAMS) {
  flash_wide_block<T, false>(UNIGEO_F32_ARGS);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_lse_wide_kernel(UNIGEO_CC_PARAMS) {
  flash_wide_block<T, true>(UNIGEO_F32_ARGS);
}

template <typename T>
cudaError_t launch_wide(Entry entry, const void* q, const void* k, const void* v, void* o,
                        float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                        int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                        int B, int Sq, int Sk, int H, int D, float scale,
                        cudaStream_t stream) {
  auto kern = entry == kFwdLse      ? flash_fwd_lse_wide_kernel<T>
              : entry == kHeadsplit ? flash_headsplit_wide_kernel<T>
                                    : flash_packed_wide_kernel<T>;
  const int DC = wide_chunk(D);
  const size_t smem = wide_smem_bytes(DC);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (int64_t)((Sq + kWideRows - 1) / kWideRows) * ((D + DC - 1) / DC);
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, Sq, Sk, D,
      scale);
  return cudaGetLastError();
}

// the CUDA-core body's three tile shapes by head width up to 512, and the
// column-chunked body past it
template <typename T>
cudaError_t launch_cuda_core(Entry entry, const void* q, const void* k, const void* v,
                             void* o, float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb,
                             int64_t k_ss, int64_t v_sb, int64_t v_ss, int64_t o_sb,
                             int64_t o_ss, int B, int Sq, int Sk, int H, int D, float scale,
                             cudaStream_t stream) {
  if (D > kWideMaxChunk)
    return launch_wide<T>(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb,
                          o_ss, B, Sq, Sk, H, D, scale, stream);
  if (D <= 64)
    return launch<T, 64, 64, 16>(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                                 o_sb, o_ss, B, Sq, Sk, H, D, scale, stream);
  if (D <= 128)
    return launch<T, 64, 64, 32>(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                                 o_sb, o_ss, B, Sq, Sk, H, D, scale, stream);
  return launch<T, 16, 32, 32>(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                               o_sb, o_ss, B, Sq, Sk, H, D, scale, stream);
}

// 16-byte tile loads need 16-byte-aligned rows: pointers, strides and the
// head offset all multiples of 16 bytes (`per16` elements: 8 bf16, 4 f32)
bool aligned16(const void* q, const void* k, const void* v, const void* o,
               int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
               int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss, int per16) {
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
  const int64_t strides = q_sb | q_ss | k_sb | k_ss | v_sb | v_ss | o_sb | o_ss;
  return (ptrs % 16) == 0 && (strides % per16) == 0;
}

// ---------------------------------------------------------------------------
// bf16 at D in {16, 64, 80}: TMA -> mbarrier ring -> wgmma, warp-specialised.
// A block owns kConsumers * 64 queries of one (batch, head): a producer
// warpgroup whose one thread issues every TMA load (q once, then k and v
// tiles of kBlockK keys into a ring of slots under full / empty mbarriers), and
// consumer warpgroups of 64 query rows each.  A consumer runs S = q k^T with
// both operands from shared memory (q by descriptor, never held in
// registers), turns the S accumulator into P's bf16 A registers, and runs
// O += P v with v read MN-major through the transpose bit.  Its loop issues
// S of tile it and P v of tile it - 1 together, then runs tile it's softmax
// while P v runs: the exponentials of one tile overlap the products of the
// other.  A row of D columns is D / W boxes of W columns (kBoxW), each a
// TMA load and a swizzle atom's width: one box at D = 16 and 64, five of 16
// columns at D = 80 (160 bytes is wider than the 128-byte swizzle span).
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;  // query rows of a consumer
// the consumers take turns to issue their products (named barriers 1 + c),
// so one's softmax runs under another's products
constexpr bool kWgPingpong = true;
// at most one block per SM, each walking over (query block, head, batch)
// items and loading its next item's q and tiles while it finishes the
// current one (two q buffers), so a short item's start-up is hidden
constexpr int kWgQBuffers = 2;
constexpr int kWgProducerRegs = 24;

// The body's shape at head width D: consumers, keys of a ring slot, ring
// slots.  CLIP's 257 tokens take 64-key tiles (five, the last of one key)
// rather than 128 (three, the last of one key): less work on zero rows.
template <int D>
struct WgShape {
  static constexpr int kConsumers = 3;
  static constexpr int kBlockK = D == 80 ? 64 : 128;
  static constexpr int kStages = 4;
  static constexpr int kBlockQ = kConsumers * kWgRows;  // queries of a block
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // the registers the producer gives up, shared among the consumers
  static constexpr int kConsumerRegs =
      (65536 - 128 * kWgProducerRegs) / (128 * kConsumers) / 8 * 8;
  static_assert(kConsumers == 2 || kConsumers == 3, "two or three consumers");
};
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// columns of a TMA box: 64 with the 128-byte swizzle, 16 with the 32-byte one
template <int D>
constexpr int kBoxW = D % 64 == 0 ? 64 : 16;

// A slot holds v before k: a descriptor that misreads v, as the planted
// transpose-bit fault of tests/test_torch_cuda.py does, still reads inside
// the slot.  Each tile is its boxes one after another: box x of rows
// [0, R) at x * R * W.
template <int D>
struct WgSmem {
  using Shape = WgShape<D>;
  struct Slot {
    __nv_bfloat16 v[Shape::kBlockK * D];
    __nv_bfloat16 k[Shape::kBlockK * D];
  };
  // consumer c's rows at q[i] + c * 64 * W in each box
  __nv_bfloat16 q[kWgQBuffers][Shape::kBlockQ * D];
  Slot slot[Shape::kStages];
  uint64_t q_full[kWgQBuffers], q_empty[kWgQBuffers], full[Shape::kStages],
      empty[Shape::kStages];
};

// 2^x by the SFU (ex2.approx.ftz: 2 ulp, results below 2^-126 flushed to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = q k^T of one consumer's 64 rows and a slot's BK keys (the first
// k-step overwrites s); qs and ks point at box 0, boxes kBlockQ * W and
// BK * W elements apart
template <int D, int BK>
__device__ __forceinline__ void issue_scores(float (&s)[BK / 2], const __nv_bfloat16* qs,
                                             const __nv_bfloat16* ks) {
  constexpr int W = kBoxW<D>;
  using Tile = sm90::SwizzledTile<W>;
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const int x = i / (W / 16), kk = i % (W / 16);  // box, k-step within it
    const uint64_t da = Tile::kmajor(qs + x * WgShape<D>::kBlockQ * W, kk);
    const uint64_t db = Tile::kmajor(ks + x * BK * W, kk);
    if constexpr (BK == 128)
      sm90::wgmma_ss128(s, da, db, i);
    else
      sm90::wgmma_ss64<0, 0>(s, da, db, i);
  }
  sm90::wgmma_commit();
}

// O += P v: A = P's registers, B = the slot's v read MN-major (its boxes
// are the atoms along N)
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[WgShape<D>::kBlockK / 16][4],
                                         const __nv_bfloat16* vs) {
  constexpr int W = kBoxW<D>, BK = WgShape<D>::kBlockK;
  using Tile = sm90::SwizzledTile<W>;
  constexpr uint32_t box = BK * W * sizeof(__nv_bfloat16);
#pragma unroll
  for (int i = 0; i < BK / 16; ++i)
    sm90::wgmma_rs<D, 1>(o, pa[i], Tile::mnmajor(vs, i, box), 1);
  sm90::wgmma_commit();
}

// One key tile of BK keys of the online softmax for this thread's two rows
// (g and g + 8 of its warp's 16).  Element 4j + e of s is the score of row
// g + 8 (e >> 1) and key 8j + 2tg + (e & 1) of the tile.  m is the running
// max in log2 units (scores times scale * log2(e)), l this thread's share
// of the row sums.  s becomes p = 2^(s * scale_log2 - m); returns
// alpha = 2^(m_old - m_new) per row.  kMask (the last tile, when Sk is
// ragged): keys with 8j + (e & 1) >= lim score -inf, since the TMA's zero
// key rows would otherwise score 0.
template <bool kMask, int BK>
__device__ __forceinline__ float2 softmax_tile(float (&s)[BK / 2], float (&m)[2],
                                               float (&l)[2], float scale_log2, int lim) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
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
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], scale_log2, -m[e >> 1]));
      l[e >> 1] += s[4 * j + e];
    }
  return make_float2(alpha[0], alpha[1]);
}

// tile it's softmax, masked where it is the last tile and Sk is ragged
template <int BK>
__device__ __forceinline__ float2 softmax_step(float (&s)[BK / 2], float (&m)[2],
                                               float (&l)[2], float scale_log2, int it,
                                               int last, bool ragged, int lim) {
  return ragged && it == last ? softmax_tile<true, BK>(s, m, l, scale_log2, lim)
                              : softmax_tile<false, BK>(s, m, l, scale_log2, lim);
}

// p (f32, the S accumulator's layout) -> the bf16 A registers of P v's
// k-steps: k-step i takes the tile's keys [16i, 16i + 16)
template <int BK>
__device__ __forceinline__ void p_to_a(uint32_t (&pa)[BK / 16][4], const float (&p)[BK / 2]) {
#pragma unroll
  for (int i = 0; i < BK / 16; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[i][r] = pack_bf16x2(p[8 * i + 2 * r], p[8 * i + 2 * r + 1]);
}

// acc *= alpha per row (the accumulator's layout: x for row g, y for g + 8)
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N / 2], float2 alpha) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    acc[4 * j] *= alpha.x;
    acc[4 * j + 1] *= alpha.x;
    acc[4 * j + 2] *= alpha.y;
    acc[4 * j + 3] *= alpha.y;
  }
}

// O / l of this thread's two rows (row0 and row0 + 8) into the N columns
// from col0 of the packed output [B, Sq, hd], and, where write_lse,
// lse = (m + log2 l) ln 2; rows past Sq, computed on the TMA's zero rows,
// are not stored.  l is summed over the quad first.
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2], float (&l)[2],
                                           const float (&m)[2], __nv_bfloat16* __restrict__ o,
                                           float* __restrict__ lse, int64_t hd, int b, int Sq,
                                           int row0, int64_t col0, int64_t lse_bh,
                                           bool write_lse, int tg) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
    if (write_lse && tg == 0) lse[lse_bh + row] = (m[i] + log2f(l[i])) * kLn2;
    const float inv = 1.f / l[i];
    __nv_bfloat16* orow = o + ((int64_t)b * Sq + row) * hd + col0 + 2 * tg;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16x2(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
  }
}

#define UNIGEO_WG_PARAMS                                                            \
  const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k, \
      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,          \
      float* __restrict__ lse, int Sq, int Sk, int H, int B, float scale_log2
#define UNIGEO_WG_ARGS tm_q, tm_k, tm_v, o, lse, Sq, Sk, H, B, scale_log2

// the body of the three wgmma kernels at D in {16, 64, 80}; kLse: write the
// row logsumexp.  Block i takes items i, i + gridDim.x, ... (item i is
// query block i % n_qb of head i / n_qb % H of batch entry i / (n_qb H));
// the ring's slots and phases run on across a block's items.
template <int D, bool kLse>
__device__ __forceinline__ void flash_wgmma_block(const CUtensorMap& tm_q,
                                                  const CUtensorMap& tm_k,
                                                  const CUtensorMap& tm_v,
                                                  __nv_bfloat16* __restrict__ o,
                                                  float* __restrict__ lse, int Sq, int Sk, int H,
                                                  int B, float scale_log2) {
  using Shape = WgShape<D>;
  constexpr int W = kBoxW<D>, BQ = Shape::kBlockQ, BK = Shape::kBlockK, NS = Shape::kStages;
  constexpr int NC = Shape::kConsumers, QB = kWgQBuffers;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WgSmem<D>& sm = sm90::aligned_smem<WgSmem<D>>(smem_raw);
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int n_tiles = (Sk + BK - 1) / BK, n_qb = (Sq + BQ - 1) / BQ;
  const int n_items = n_qb * H * B;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      sm90::mbar_init(&sm.empty[s], 4 * NC);  // one arrival per consumer warp
    }
#pragma unroll
    for (int i = 0; i < QB; ++i) {
      sm90::mbar_init(&sm.q_full[i], 1);
      sm90::mbar_init(&sm.q_empty[i], 4 * NC);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every TMA load, a box at a time
    sm90::setmaxnreg_dec<kWgProducerRegs>();
    if (threadIdx.x == 0) {
      int gt = 0;  // the block's tiles so far
      for (int item = blockIdx.x, j = 0; item < n_items; item += gridDim.x, ++j) {
        const int q0 = item % n_qb * BQ, h = item / n_qb % H, b = item / (n_qb * H);
        const int qb = j % QB;
        sm90::mbar_wait(&sm.q_empty[qb], ((j / QB) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&sm.q_full[qb], BQ * D * sizeof(__nv_bfloat16));
#pragma unroll
        for (int x = 0; x < D / W; ++x)
          sm90::tma_load_3d(sm.q[qb] + x * BQ * W, &tm_q, &sm.q_full[qb], h * D + x * W, q0,
                            b);
        for (int it = 0; it < n_tiles; ++it, ++gt) {
          const int s = gt % NS;
          sm90::mbar_wait(&sm.empty[s], ((gt / NS) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * BK * D * sizeof(__nv_bfloat16));
#pragma unroll
          for (int x = 0; x < D / W; ++x) {
            sm90::tma_load_3d(sm.slot[s].k + x * BK * W, &tm_k, &sm.full[s],
                              h * D + x * W, it * BK, b);
            sm90::tma_load_3d(sm.slot[s].v + x * BK * W, &tm_v, &sm.full[s],
                              h * D + x * W, it * BK, b);
          }
        }
      }
    }
    return;
  }

  // consumer c: queries [q0 + 64c, q0 + 64c + 64) of each item
  sm90::setmaxnreg_inc<Shape::kConsumerRegs>();
  const int c = wg - 1, w = (threadIdx.x / 32) % 4, g = lane / 4, tg = lane % 4;
  const int last = n_tiles - 1;
  const bool ragged = Sk % BK != 0;
  const int lim = Sk - last * BK - 2 * tg;  // the last tile's mask bound
  // the consumers' turns, in the order 0, 1, ...: c issues between a sync
  // on its barrier (1 + c) and an arrival on the next one's; consumer 0
  // goes first, and the last consumer's last turn passes nothing on, so
  // every arrival is consumed
  const int next = 1 + (c + 1) % NC;
  const auto turn = [&] {
    if constexpr (kWgPingpong) sm90::bar_sync<2 * 128>(1 + c);
  };
  const auto pass = [&](bool more) {
    if constexpr (kWgPingpong)
      if (more) sm90::bar_arrive<2 * 128>(next);
  };
  const auto arrive = [&](uint64_t* bar) {  // one arrival per warp
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(bar);
  };
  if (kWgPingpong && c == NC - 1) sm90::bar_arrive<2 * 128>(1);

  int gt = 0;  // the block's tiles so far
  for (int item = blockIdx.x, j = 0; item < n_items; item += gridDim.x, ++j, gt += n_tiles) {
    const int q0 = item % n_qb * BQ, h = item / n_qb % H, b = item / (n_qb * H);
    const int qb = j % QB;
    const bool final_item = item + (int)gridDim.x >= n_items;
    const __nv_bfloat16* qs = sm.q[qb] + c * kWgRows * W;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float s[BK / 2];
    uint32_t pa[BK / 16][4];
    sm90::mbar_wait(&sm.q_full[qb], (j / QB) & 1);

    // tile 0: S, its softmax, P
    sm90::mbar_wait(&sm.full[gt % NS], (gt / NS) & 1);
    turn();
    sm90::wgmma_fence();
    issue_scores<D, BK>(s, qs, sm.slot[gt % NS].k);
    pass(true);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    if (last == 0) arrive(&sm.q_empty[qb]);  // q's last product is done
    softmax_step<BK>(s, m, l, scale_log2, 0, last, ragged, lim);
    p_to_a<BK>(pa, s);

    for (int it = 1; it < n_tiles; ++it) {
      const int sl = (gt + it) % NS, prev = (gt + it - 1) % NS;
      sm90::mbar_wait(&sm.full[sl], ((gt + it) / NS) & 1);
      // S(it), and O += P(it - 1) v(it - 1) behind it
      sm90::fence_regs(pa);
      sm90::fence_regs(acc);
      turn();
      sm90::wgmma_fence();
      issue_scores<D, BK>(s, qs, sm.slot[sl].k);
      issue_pv<D>(acc, pa, sm.slot[prev].v);
      pass(true);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      if (it == last) arrive(&sm.q_empty[qb]);
      // tile it's softmax while P(it - 1) v(it - 1) runs
      const float2 alpha = softmax_step<BK>(s, m, l, scale_log2, it, last, ragged, lim);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(pa);
      arrive(&sm.empty[prev]);  // slot it - 1 is free
      rescale<D>(acc, alpha);
      p_to_a<BK>(pa, s);
    }

    // O += P(last) v(last)
    const int sl = (gt + last) % NS;
    sm90::fence_regs(pa);
    sm90::fence_regs(acc);
    turn();
    sm90::wgmma_fence();
    issue_pv<D>(acc, pa, sm.slot[sl].v);
    pass(!final_item || c != NC - 1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    arrive(&sm.empty[sl]);

    store_rows<D>(acc, l, m, o, lse, (int64_t)H * D, b, Sq, q0 + c * kWgRows + 16 * w + g,
                  (int64_t)h * D, ((int64_t)b * H + h) * Sq, kLse, tg);
  }
}

template <int D>
__global__ void __launch_bounds__(WgShape<D>::kThreads, 1)
    flash_packed_wgmma_kernel(UNIGEO_WG_PARAMS) {
  flash_wgmma_block<D, false>(UNIGEO_WG_ARGS);
}

template <int D>
__global__ void __launch_bounds__(WgShape<D>::kThreads, 1)
    flash_headsplit_wgmma_kernel(UNIGEO_WG_PARAMS) {
  flash_wgmma_block<D, false>(UNIGEO_WG_ARGS);
}

template <int D>
__global__ void __launch_bounds__(WgShape<D>::kThreads, 1)
    flash_fwd_lse_wgmma_kernel(UNIGEO_WG_PARAMS) {
  flash_wgmma_block<D, true>(UNIGEO_WG_ARGS);
}

// ---------------------------------------------------------------------------
// bf16 at D = 512 (the VAE mid block's one head): TMA -> two mbarrier rings
// -> wgmma, warp-specialised.  A 64-row f32 accumulator over 512 columns
// would take 256 registers a thread of one warpgroup, so a block owns 64
// query rows of one (batch, head) and two consumer warpgroups split them by
// output column: consumer c holds O[:, 256c, 256c + 256) (128 registers)
// and sums the matching half of q k^T's d-sum.  A producer thread loads q
// once (eight 64-column boxes, 64 KB) and keeps rings of k and of v tiles of
// kW5BlockK keys full, each box of a tile its own TMA load; a k slot is
// freed as soon as both partial S are taken, a v slot after its P v.  Per
// key tile, consumer c runs its partial S_c = q[:, half c] k[:, half c]^T
// (sixteen k-steps from shared memory), trades it for the other's through
// shared memory at a named barrier, and both form S = S_0 + S_1 (f32
// addition commutes, so both hold the same bits) and run the same online
// softmax; then O_c += P v[:, half c] as m64n256 wgmma with P from
// registers and v MN-major.  As in the body above, S of tile it is issued
// with P v of tile it - 1, and the trade and the softmax run under P v.
// ---------------------------------------------------------------------------

constexpr int kW5D = 512;
constexpr int kW5Rows = 64;     // query rows of a block
constexpr int kW5Half = 256;    // output columns of a consumer
constexpr int kW5BlockK = 32;   // keys of a ring slot
constexpr int kW5Stages = 2;    // slots of each ring
constexpr int kW5Threads = 3 * 128;
constexpr int kW5ConsumerRegs = 240;
constexpr int kW5Boxes = kW5D / 64;  // 64-column boxes of a row

struct W5Smem {
  __nv_bfloat16 q[kW5Boxes][kW5Rows * 64];
  __nv_bfloat16 k[kW5Stages][kW5Boxes][kW5BlockK * 64];
  __nv_bfloat16 v[kW5Stages][kW5Boxes][kW5BlockK * 64];
  // partial S by tile parity and consumer: thread t's float4 f at [f][t].
  // Two parities let one barrier a tile separate a write from the other
  // consumer's read two tiles back.
  float4 x[2][2][kW5BlockK / 8][128];
  uint64_t q_full, k_full[kW5Stages], k_empty[kW5Stages], v_full[kW5Stages],
      v_empty[kW5Stages];
};

// consumer c's partial S over its 256 columns of d (sixteen k-steps)
__device__ __forceinline__ void issue_scores512(float (&s)[kW5BlockK / 2], const W5Smem& sm,
                                                int slot, int c) {
  using Tile = sm90::SwizzledTile<64>;
#pragma unroll
  for (int i = 0; i < kW5Half / 16; ++i) {
    const int x = 4 * c + i / 4;
    const uint64_t da = Tile::kmajor(sm.q[x], i % 4), db = Tile::kmajor(sm.k[slot][x], i % 4);
    sm90::wgmma_ss32(s, da, db, i);
  }
  sm90::wgmma_commit();
}

// O_c += P v[:, half c]: v's four boxes of half c are the atoms along N
__device__ __forceinline__ void issue_pv512(float (&o)[kW5Half / 2],
                                            const uint32_t (&pa)[kW5BlockK / 16][4],
                                            const W5Smem& sm, int slot, int c) {
  using Tile = sm90::SwizzledTile<64>;
  constexpr uint32_t box = kW5BlockK * 64 * sizeof(__nv_bfloat16);
#pragma unroll
  for (int i = 0; i < kW5BlockK / 16; ++i)
    sm90::wgmma_rs<kW5Half, 1>(o, pa[i], Tile::mnmajor(sm.v[slot][4 * c], i, box), 1);
  sm90::wgmma_commit();
}

// S = S_0 + S_1: this consumer's partial out, the other's in (thread t of
// both consumers holds the same elements of S)
__device__ __forceinline__ void trade_scores(float (&s)[kW5BlockK / 2], W5Smem& sm, int par,
                                             int c, int t) {
#pragma unroll
  for (int f = 0; f < kW5BlockK / 8; ++f)
    sm.x[par][c][f][t] = make_float4(s[4 * f], s[4 * f + 1], s[4 * f + 2], s[4 * f + 3]);
  sm90::bar_sync<256>(1);
#pragma unroll
  for (int f = 0; f < kW5BlockK / 8; ++f) {
    const float4 y = sm.x[par][c ^ 1][f][t];
    s[4 * f] += y.x;
    s[4 * f + 1] += y.y;
    s[4 * f + 2] += y.z;
    s[4 * f + 3] += y.w;
  }
}

// consumer c of a d = 512 block: output columns [256c, 256c + 256) of its
// 64 rows
template <bool kLse>
__device__ __forceinline__ void consume512(W5Smem& sm, __nv_bfloat16* __restrict__ o,
                                           float* __restrict__ lse, int Sq, int Sk,
                                           float scale_log2, int q0, int h, int b, int H) {
  constexpr int BK = kW5BlockK, S = kW5Stages;
  const int n_tiles = (Sk + BK - 1) / BK;
  const int lane = threadIdx.x % 32;
  const int c = threadIdx.x / 128 - 1, t = threadIdx.x % 128, w = t / 32, g = lane / 4,
            tg = lane % 4;
  const int last = n_tiles - 1;
  const bool ragged = Sk % BK != 0;
  const int lim = Sk - last * BK - 2 * tg;  // the last tile's mask bound
  float acc[kW5Half / 2];
#pragma unroll
  for (int i = 0; i < kW5Half / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[BK / 2];
  uint32_t pa[BK / 16][4];
  const auto free_slot = [&](uint64_t* empty) {  // one arrival per warp
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty);
  };
  sm90::mbar_wait(&sm.q_full, 0);

  // tile 0: S, its softmax, P
  sm90::mbar_wait(&sm.k_full[0], 0);
  sm90::wgmma_fence();
  issue_scores512(s, sm, 0, c);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  free_slot(&sm.k_empty[0]);
  trade_scores(s, sm, 0, c, t);
  softmax_step<BK>(s, m, l, scale_log2, 0, last, ragged, lim);
  p_to_a<BK>(pa, s);

  for (int it = 1; it < n_tiles; ++it) {
    const int sl = it % S, prev = (it - 1) % S;
    sm90::mbar_wait(&sm.k_full[sl], (it / S) & 1);
    sm90::mbar_wait(&sm.v_full[prev], ((it - 1) / S) & 1);
    // S_c(it), and O_c += P(it - 1) v(it - 1) behind it
    sm90::fence_regs(pa);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    issue_scores512(s, sm, sl, c);
    issue_pv512(acc, pa, sm, prev, c);
    sm90::wgmma_wait<1>();
    sm90::fence_regs(s);
    free_slot(&sm.k_empty[sl]);
    // the trade and tile it's softmax while P(it - 1) v(it - 1) runs
    trade_scores(s, sm, it & 1, c, t);
    const float2 alpha = softmax_step<BK>(s, m, l, scale_log2, it, last, ragged, lim);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_regs(pa);
    free_slot(&sm.v_empty[prev]);
    rescale<kW5Half>(acc, alpha);
    p_to_a<BK>(pa, s);
  }

  // O_c += P(last) v(last)
  sm90::mbar_wait(&sm.v_full[last % S], (last / S) & 1);
  sm90::fence_regs(pa);
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
  issue_pv512(acc, pa, sm, last % S, c);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  // both consumers hold the same m and l: consumer 0 writes the lse
  store_rows<kW5Half>(acc, l, m, o, lse, (int64_t)H * kW5D, b, Sq, q0 + 16 * w + g,
                      (int64_t)h * kW5D + kW5Half * c, ((int64_t)b * H + h) * Sq,
                      kLse && c == 0, tg);
}

template <bool kLse>
__device__ __forceinline__ void flash_wgmma512_block(const CUtensorMap& tm_q,
                                                     const CUtensorMap& tm_k,
                                                     const CUtensorMap& tm_v,
                                                     __nv_bfloat16* __restrict__ o,
                                                     float* __restrict__ lse, int Sq, int Sk,
                                                     int H, int /*B: the grid's z*/,
                                                     float scale_log2) {
  constexpr int BK = kW5BlockK, S = kW5Stages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W5Smem& sm = sm90::aligned_smem<W5Smem>(smem_raw);
  const int q0 = blockIdx.x * kW5Rows, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (Sk + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&sm.k_full[s], 1);
      sm90::mbar_init(&sm.v_full[s], 1);
      sm90::mbar_init(&sm.k_empty[s], 8);  // one arrival per consumer warp
      sm90::mbar_init(&sm.v_empty[s], 8);
    }
    sm90::mbar_init(&sm.q_full, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: q once, then each k and v tile a box at a time
    sm90::setmaxnreg_dec<kWgProducerRegs>();
    if (threadIdx.x == 0) {
      constexpr uint32_t tile_bytes = BK * kW5D * sizeof(__nv_bfloat16);
      sm90::mbar_arrive_expect_tx(&sm.q_full, kW5Rows * kW5D * sizeof(__nv_bfloat16));
#pragma unroll
      for (int x = 0; x < kW5Boxes; ++x)
        sm90::tma_load_3d(sm.q[x], &tm_q, &sm.q_full, h * kW5D + 64 * x, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S, free_parity = ((it / S) & 1) ^ 1;
        sm90::mbar_wait(&sm.k_empty[s], free_parity);
        sm90::mbar_arrive_expect_tx(&sm.k_full[s], tile_bytes);
#pragma unroll
        for (int x = 0; x < kW5Boxes; ++x)
          sm90::tma_load_3d(sm.k[s][x], &tm_k, &sm.k_full[s], h * kW5D + 64 * x, it * BK, b);
        sm90::mbar_wait(&sm.v_empty[s], free_parity);
        sm90::mbar_arrive_expect_tx(&sm.v_full[s], tile_bytes);
#pragma unroll
        for (int x = 0; x < kW5Boxes; ++x)
          sm90::tma_load_3d(sm.v[s][x], &tm_v, &sm.v_full[s], h * kW5D + 64 * x, it * BK, b);
      }
    }
  } else {
    sm90::setmaxnreg_inc<kW5ConsumerRegs>();
    consume512<kLse>(sm, o, lse, Sq, Sk, scale_log2, q0, h, b, H);
  }
}

__global__ void __launch_bounds__(kW5Threads, 1)
    flash_packed_wgmma512_kernel(UNIGEO_WG_PARAMS) {
  flash_wgmma512_block<false>(UNIGEO_WG_ARGS);
}

__global__ void __launch_bounds__(kW5Threads, 1)
    flash_headsplit_wgmma512_kernel(UNIGEO_WG_PARAMS) {
  flash_wgmma512_block<false>(UNIGEO_WG_ARGS);
}

__global__ void __launch_bounds__(kW5Threads, 1)
    flash_fwd_lse_wgmma512_kernel(UNIGEO_WG_PARAMS) {
  flash_wgmma512_block<true>(UNIGEO_WG_ARGS);
}

// ---------------------------------------------------------------------------
// f32 at D = 64 (Spann3R's and UniGeoCam's pointmap path): a register-tiled
// CUDA-core body fed by a cp.async ring, flash_{packed,headsplit,
// fwd_lse}_f32reg_kernel<kWarps, kStages, kSplit>.  Exact f32: every
// product and sum is an f32 FMA or add on the CUDA cores (no tensor core, so
// no TF32), the exponentials the SFU's ex2 in log2 units.
//
// A block owns kRows = 16 kWarps query rows of one (batch, head); a warp
// owns 16 rows whole, so the softmax and P stay inside the warp.  Lane
// (rg, cl) = (lane / 8, lane % 8) holds rows rg + 4i (i < kRegTM = 4) of
// its warp's, the scores of keys cl + 8j (j < 8) of each 64-key tile, and
// the output columns [4cl, 4cl + 4) and [32 + 4cl, 36 + 4cl).  (8 rows a
// lane need more than 255 registers and spill.)
//
// * S = q k^T reads q and k as they lie (rows of 64 f32, 68 apart in shared
//   memory) in 16-byte loads along d: for 4 d at a time, 4 q loads and 8 k
//   loads feed 128 FMAs (10.7 per load).  The 68-float pitch puts rows 1 apart 4 banks apart, so the
//   8 keys a quarter-warp reads and the 4 rows a warp reads at once fall in
//   distinct banks; the other lanes read the same addresses (broadcasts).
//   No transpose is needed: a d-major copy would feed the same FMAs per
//   load.
// * The row max is three shuffles within the row's 8 lanes; l is kept per
//   lane (its keys' share) and summed over the 8 lanes once, at the end.
// * P goes through a warp's own [64][16] buffer in shared memory: a lane
//   stores its 4 rows of key kk as one 16-byte slot, which the row group's
//   lanes read back, one load per key; the slots are XOR-swizzled by kk
//   (p_offset), so the 8 stores of a quarter-warp fall in distinct banks.
// * O += P v: per key, one load of P and 2 of v (16 bytes each, the 8 lanes
//   of a row group 128 contiguous bytes) feed 32 FMAs.
//
// The copies: every thread issues 16-byte cp.async (L2 only) for its share
// of q (once) and of each k and v tile into a ring of kStages slots, one
// commit group per tile; at tile it a thread waits for its own group, one
// __syncthreads makes every thread's copies visible and frees the slot of
// tile it - 1, which then takes tile it + kStages - 1 while tile it is
// computed.  cp.async and not the TMA: the TMA's boxes cannot give q and k
// the 68-float pitch that spreads rows over the banks (its swizzles exist
// for 16-bit tensor-core tiles), and a padded box row is refused.  Rows past
// Sk (Sq) are zero-filled by the copy; the last key tile, when Sk is
// ragged, selects -inf for them, and query rows past Sq are computed on
// zeros and not stored, nor is their lse.
//
// kSplit > 1 (few items, the decoder's [1, 768, 8, 64]): the key tiles are
// split over the kSplit blocks of a cluster (block r takes tiles
// [r n / kSplit, (r + 1) n / kSplit)), each keeps its partial (m, l, acc)
// in its shared memory, and after a cluster barrier block r merges rows
// [r kRows / kSplit, (r + 1) kRows / kSplit) from all the blocks' shared
// memory in rank order (M = max m_s, w_s = 2^(m_s - M), O = sum w_s acc_s /
// sum w_s l_s): no atomics and a fixed order, so two launches give the same
// bits.
// ---------------------------------------------------------------------------

constexpr int kRegD = 64;              // the body's head width
constexpr int kRegPitch = kRegD + 4;   // q and k rows in shared memory, floats
constexpr int kRegTM = 4;              // a lane's query rows
constexpr int kRegBK = 64;             // keys of a tile
// the products' loops unrolled by 4 steps of 4 d (S) and by 16 keys (P v):
// the loop bodies stay small enough for the instruction caches
constexpr int kRegUnrollD = 4, kRegUnrollK = 16;

template <int kWarps, int kStages, int kSplit>
struct RegShape {
  static constexpr int kWarpRows = 4 * kRegTM;  // a warp's query rows: kRegTM a lane
  static constexpr int kRows = kWarpRows * kWarps;  // query rows of a block
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTN = kRegBK / 8;         // a lane's keys of a tile
  static constexpr int kQFloats = kRows * kRegPitch;
  static constexpr int kSlotFloats = kRegBK * kRegPitch + kRegBK * kRegD;  // k, then v
  static constexpr int kPFloats = kRegBK * kWarpRows;  // a warp's P buffer
  static constexpr int kFloats = kQFloats + kStages * kSlotFloats + kWarps * kPFloats;
  // blocks an SM holds by shared memory (227 KB, 1 KB reserved a block),
  // at most 4; the launch bounds hold registers to what that many need
  static constexpr int kBlocksPerSm =
      232448 / (kFloats * 4 + 1024) < 4 ? 232448 / (kFloats * 4 + 1024) : 4;
  // the merge's partials (acc [kRows][64], m, l) over the ring's slots
  static constexpr int kMergeFloats = kRows * (kRegD + 2);
  static_assert(kRegTM == 4, "a lane's rows of a key fill one 16-byte slot of P");
  static_assert(kStages >= 2, "a ring of at least two slots");
  static_assert(kSplit == 1 || kSplit == 2 || kSplit == 4, "clusters of 1, 2 or 4");
  static_assert(kRows % kSplit == 0 && kMergeFloats <= kStages * kSlotFloats, "merge space");
  static_assert(kRows * 16 % kThreads == 0 && kRegBK * 16 % kThreads == 0, "whole copies");
};

// rows [r0, r0 + R) of one head's rows `src` (row stride ss floats) into
// shared `dst` at `pitch` floats a row, 16 bytes per copy; rows at or past
// `lim` are zero-filled (r0 < lim, so row r0 is a valid address)
template <int R, int kThreads>
__device__ __forceinline__ void copy_rows(float* dst, int pitch, const float* src, int64_t ss,
                                          int r0, int lim, int tid) {
#pragma unroll
  for (int n = 0; n < R * 16 / kThreads; ++n) {
    const int c = tid + n * kThreads, r = c / 16, x = 4 * (c % 16);
    const bool ok = r0 + r < lim;
    sm90::cp_async16(dst + r * pitch + x, src + (int64_t)(ok ? r0 + r : r0) * ss + x, ok);
  }
}

// The float offset in a warp's P buffer (4 float4 slots a key, one per row
// group) of key kk's slot of row group rg, XORed with a pattern of kk that
// spreads a quarter-warp's 8 keys (cl + 8j) over distinct banks (two keys
// share a 128-byte row of the buffer)
__device__ __forceinline__ int p_offset(int kk, int rg) {
  return 16 * kk + 4 * (rg ^ ((kk >> 1) & 3));
}

// the body of the three f32reg kernels; kLse: write the row logsumexp
template <int kWarps, int kStages, int kSplit, bool kLse>
__device__ __forceinline__ void flash_f32reg_block(UNIGEO_F32_PARAMS) {
  using Shape = RegShape<kWarps, kStages, kSplit>;
  constexpr int BQ = Shape::kRows, NT = Shape::kThreads, TN = Shape::kTN, P = kRegPitch;
  constexpr int kTM = kRegTM, kBK = kRegBK;
  extern __shared__ __align__(16) float f32reg_smem[];
  float* qs = f32reg_smem;                          // [BQ][68]
  float* ring = qs + Shape::kQFloats;               // kStages x (k [kBK][68], v [kBK][64])
  float* ps = ring + kStages * Shape::kSlotFloats;  // kWarps x [kBK][16]

  const float scale_log2 = scale;  // the launch passes scale * log2 e
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane / 8, cl = lane % 8;
  const int split = kSplit > 1 ? (int)sm90::cluster_rank() : 0;
  const int q0 = blockIdx.x / kSplit * BQ, h = blockIdx.y, b = blockIdx.z;
  const int n_all = (Sk + kBK - 1) / kBK;
  const int t0 = split * n_all / kSplit, n_tiles = (split + 1) * n_all / kSplit - t0;
  const bool ragged = Sk % kBK != 0;

  const float* qb = q + b * q_sb + (int64_t)h * kRegD;
  const float* kb = k + b * k_sb + (int64_t)h * kRegD;
  const float* vb = v + b * v_sb + (int64_t)h * kRegD;
  const auto issue = [&](int it) {  // tile t0 + it into its slot
    float* slot = ring + it % kStages * Shape::kSlotFloats;
    const int k0 = (t0 + it) * kBK;
    copy_rows<kBK, NT>(slot, P, kb, k_ss, k0, Sk, tid);
    copy_rows<kBK, NT>(slot + kBK * P, kRegD, vb, v_ss, k0, Sk, tid);
  };
  copy_rows<BQ, NT>(qs, P, qb, q_ss, q0, Sq, tid);  // q joins tile 0's group
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < n_tiles) issue(it);
    sm90::cp_async_commit();
  }

  const int row0 = warp * Shape::kWarpRows + rg;  // this lane's rows: row0 + 4i
  float* pw = ps + warp * Shape::kPFloats;
  float acc[kTM][8], m[kTM], l[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    sm90::cp_async_wait<kStages - 2>();  // this thread's copies of tile it
    __syncthreads();                     // everyone's; and tile it - 1 is consumed
    if (it + kStages - 1 < n_tiles) issue(it + kStages - 1);
    sm90::cp_async_commit();  // (empty past the last tile: the count stays uniform)
    const float* ks = ring + it % kStages * Shape::kSlotFloats;
    const float* vs = ks + kBK * P;

    // S = q k^T for rows row0 + 4i and keys cl + 8j
    float s[kTM][TN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll (kRegUnrollD)
    for (int dc = 0; dc < kRegD; dc += 4) {
      float4 qv[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (row0 + 4 * i) * P + dc);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (cl + 8 * j) * P + dc);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    // the online softmax in log2 units; keys past Sk (the ragged last
    // tile's zero rows) score -inf
    if (ragged && t0 + it == n_all - 1) {
      const int lim = Sk - (t0 + it) * kBK;
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int i = 0; i < kTM; ++i) s[i][j] = cl + 8 * j < lim ? s[i][j] : -INFINITY;
    }
    float alpha[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < TN; ++j) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx * scale_log2);  // finite: each tile has a key
      alpha[i] = exp2_approx(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = exp2_approx(fmaf(s[i][j], scale_log2, -m_new));
        l[i] += s[i][j];
      }
    }

    // P into the warp's buffer: key kk's rows row0 + 4i in one slot
    __syncwarp();  // the warp's lanes have read the previous tile's P
#pragma unroll
    for (int j = 0; j < TN; ++j)
      *reinterpret_cast<float4*>(pw + p_offset(cl + 8 * j, rg)) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncwarp();

    // O = alpha O + P v
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha[i];
    const float* vc = vs + 4 * cl;
    static_assert(kRegUnrollK % 8 == 0, "P's slot pattern repeats every 8 keys");
#pragma unroll (kRegUnrollK)
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(pw + p_offset(kk, rg));
      const float pr[kTM] = {p.x, p.y, p.z, p.w};
      const float4 va = *reinterpret_cast<const float4*>(vc + kk * kRegD);
      const float4 vb4 = *reinterpret_cast<const float4*>(vc + kk * kRegD + 32);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        acc[i][0] = fmaf(pr[i], va.x, acc[i][0]);
        acc[i][1] = fmaf(pr[i], va.y, acc[i][1]);
        acc[i][2] = fmaf(pr[i], va.z, acc[i][2]);
        acc[i][3] = fmaf(pr[i], va.w, acc[i][3]);
        acc[i][4] = fmaf(pr[i], vb4.x, acc[i][4]);
        acc[i][5] = fmaf(pr[i], vb4.y, acc[i][5]);
        acc[i][6] = fmaf(pr[i], vb4.z, acc[i][6]);
        acc[i][7] = fmaf(pr[i], vb4.w, acc[i][7]);
      }
    }
  }

  // l over the row's 8 lanes
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
  }
  float* lse_h = kLse ? lse + ((int64_t)b * gridDim.y + h) * Sq : nullptr;  // this head's rows
  if constexpr (kSplit == 1) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = q0 + row0 + 4 * i;
      if (row >= Sq) continue;
      const float inv = 1.f / l[i];
      float* orow = o + b * o_sb + row * o_ss + (int64_t)h * kRegD + 4 * cl;
      *reinterpret_cast<float4*>(orow) =
          make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
      *reinterpret_cast<float4*>(orow + 32) =
          make_float4(acc[i][4] * inv, acc[i][5] * inv, acc[i][6] * inv, acc[i][7] * inv);
      if (kLse && cl == 0) lse_h[row] = kLn2 * (m[i] + log2f(l[i]));
    }
  } else {
    // the partials over the ring (every copy has landed and been read)
    sm90::cp_async_wait<0>();
    __syncthreads();
    float* part = ring;                     // acc [BQ][64]
    float* part_m = part + BQ * kRegD;      // m [BQ]
    float* part_l = part_m + BQ;            // l [BQ]
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = row0 + 4 * i;
      *reinterpret_cast<float4*>(part + r * kRegD + 4 * cl) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(part + r * kRegD + 32 + 4 * cl) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      if (cl == 0) {
        part_m[r] = m[i];
        part_l[r] = l[i];
      }
    }
    sm90::cluster_sync();  // every block's partials are written
    constexpr int R = BQ / kSplit;  // rows this block merges
    static_assert(R * 16 % NT == 0, "whole merge steps");
#pragma unroll
    for (int n = 0; n < R * 16 / NT; ++n) {
      const int c = tid + n * NT;
      const int r = split * R + c / 16, x = 4 * (c % 16), row = q0 + r;
      float ms[kSplit], mx = -INFINITY;
#pragma unroll
      for (int sp = 0; sp < kSplit; ++sp) {
        ms[sp] = sm90::ld_cluster_f32(part_m + r, sp);
        mx = fmaxf(mx, ms[sp]);
      }
      float lsum = 0.f;
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int sp = 0; sp < kSplit; ++sp) {  // rank order
        const float w = exp2_approx(ms[sp] - mx);
        const float4 a = sm90::ld_cluster_f32x4(part + r * kRegD + x, sp);
        lsum = fmaf(w, sm90::ld_cluster_f32(part_l + r, sp), lsum);
        y = make_float4(fmaf(w, a.x, y.x), fmaf(w, a.y, y.y), fmaf(w, a.z, y.z),
                        fmaf(w, a.w, y.w));
      }
      if (row < Sq) {
        const float inv = 1.f / lsum;
        *reinterpret_cast<float4*>(o + b * o_sb + row * o_ss + (int64_t)h * kRegD + x) =
            make_float4(y.x * inv, y.y * inv, y.z * inv, y.w * inv);
        if (kLse && x == 0) lse_h[row] = kLn2 * (mx + log2f(lsum));
      }
    }
    sm90::cluster_sync();  // no block leaves while another reads its partials
  }
}

// one kernel per entry point, so a profile tells them apart by name; the
// scale arrives in log2 units (scale * log2 e)
template <int kWarps, int kStages, int kSplit>
__global__ void __launch_bounds__(32 * kWarps, (RegShape<kWarps, kStages, kSplit>::kBlocksPerSm))
    flash_packed_f32reg_kernel(UNIGEO_F32_PARAMS) {
  flash_f32reg_block<kWarps, kStages, kSplit, false>(UNIGEO_F32_ARGS);
}

template <int kWarps, int kStages, int kSplit>
__global__ void __launch_bounds__(32 * kWarps, (RegShape<kWarps, kStages, kSplit>::kBlocksPerSm))
    flash_headsplit_f32reg_kernel(UNIGEO_F32_PARAMS) {
  flash_f32reg_block<kWarps, kStages, kSplit, false>(UNIGEO_F32_ARGS);
}

template <int kWarps, int kStages, int kSplit>
__global__ void __launch_bounds__(32 * kWarps, (RegShape<kWarps, kStages, kSplit>::kBlocksPerSm))
    flash_fwd_lse_f32reg_kernel(UNIGEO_F32_PARAMS) {
  flash_f32reg_block<kWarps, kStages, kSplit, true>(UNIGEO_F32_ARGS);
}

// ---------------------------------------------------------------------------
// f32 at D = 512 (the DepthCrafter trainer's f32 target encode: the VAE mid
// block's one head over 25 frames' 48 x 64 latents, [25, 3072, 1, 512]): a
// register-tiled CUDA-core body fed by the TMA, flash_{packed,headsplit,
// fwd_lse}_f32w512_kernel<kBK>.  Exact f32 as the body above: every product
// and sum an f32 FMA or add on the CUDA cores, the exponentials the SFU's ex2
// in log2 units.
//
// What bounds it: 4*B*H*Sq*Sk*D operations at the CUDA cores' 67 TF/s (7.21 ms
// at [25, 3072, 1, 512]) against 4*B*H*D*(2*Sq + 2*Sk) bytes (0.19 ms).  What
// held the earlier body (flash_f32_block<16, 32, 32>) to 5.8% of that rate:
// one 4-byte shared load per FMA, scalar copies between two barriers with
// nothing to overlap them (one 166 KB block an SM), and 16-row blocks that
// stream every key's 4 KB of k and v from L2 (60 GB a call).
//
// A block owns an item of kW512Rows = 64 query rows of one (batch, head) and
// 8 warps (256 threads, one block an SM); warp w owns the 64-wide slice
// [64w, 64w + 64) of d.  Per key tile of kBK = 16 keys:
//
// * S: warp w computes the partial scores S_w = q[:, slice w] k[:, slice
//   w]^T of all 64 rows and the tile's keys, only from its slices of q and
//   k.  Lane (rr, kc) = (lane / 4, lane % 4) holds rows rr + 8i (i < 8) and
//   keys kc + 4j (j < 4): per 4 d, 8 q and 4 k loads of 16 bytes feed 128
//   FMAs (10.7 a load), each sum in the order of d.
// * The trade: every warp writes its partials to shared memory, and warp o
//   (the owner of rows [8o, 8o + 8)) adds up its rows' 8 partials in warp
//   order, S = ((S_0 + S_1) + S_2) + ..., and runs the online softmax on
//   them (running max in log2 units, alpha = 2^(m_old - m_new), p = 2^(S
//   scale log2 e - m)), lane (lane / 4, lane % 4) taking one row's keys
//   lane % 4 + 4j.  Owners write P and alpha where their partials were.
//   Each row's softmax runs once, spread over the 8 warps, where every warp
//   running it on all 64 rows would read 8 times the partials and take 8
//   times the exponentials.
// * O += P v: warp w owns O's columns of its slice; lane (pr, pc) = (lane /
//   4, lane % 4) holds rows 8pr + i (i < 8) and the columns 4(pc + 4jj) + e
//   (jj, e < 4): O is 128 registers a lane, 64 x 512 x 4 bytes = 128 KB a
//   block, half the SM's register file.  Per key, 2 loads of P and 4 of v
//   (16 bytes each) feed 128 FMAs (21.3 a load), keys in order.
//
// Registers a lane: O 128, the partial scores 32 and their 12 loads' 48
// during S; at one block an SM the launch allows 255.  Shared memory, f32:
// q 64 x 516 (132,096 bytes, resident), one k tile 16 x 516 (33,024), one v
// tile 16 x 512 (32,768), the partials 8 warps x 8 owners x 132 (33,792) and
// two mbarriers: 231,696 bytes of the 232,448 a block may take, so one
// block an SM.  q and
// k rows are padded to 516 floats (rows 4 banks apart): the 8 rows of q and
// the 4 keys a warp reads at one d fall in distinct banks, and every load's
// address is one base a lane plus an immediate.  (The TMA's row copies
// cannot XOR-swizzle 16-byte chunks; fed by cp.async, such a swizzle of
// unpadded rows cost an XOR and an add a load: 15.13 device ms against
// 14.45 padded on an H100 SXM at 700 W, tools/forward_variants.py.)  An
// owner's region of the partials is 132 floats, 128 and 4 of padding, so
// the 8 regions P is read from lie 4 banks apart: every access above is
// free of bank conflicts.  L2: each item reads q once and all of k and v
// (12.6 MB at Sk = 3072): 1200 items x 12.7 MB = 15.3 GB a call, about
// 2.6 ms at the 5.8 TB/s the bf16 body at d = 512 draws from L2, under the
// FMA bound.
//
// The copies: the TMA's bulk copies (no tensor map), one 2 KB row each,
// issued by the lanes of warp 0 into the padded rows, each tile's bytes
// completing on an mbarrier of its own (k's, with q's on tile 0, and v's):
// 16-byte cp.async from every thread takes 280 address instructions and 16
// copies a thread a tile (with the copies cut out, that body took 12.2 ms
// against 14.7 at [25, 3072, 1, 512] on an H100 SXM at 700 W).  One slot
// each for k and v: v(it) is copied while S(it) runs, k(it + 1) while the
// trade and P v(it) run.  Three barriers a tile: T (P v(it - 1) is done, so v and the
// partials are free), A (the partials are written; k(it) is read) and C (P,
// alpha and v(it)'s zero rows are visible); each thread waits for k(it) and
// v(it) on their mbarriers.  The rows past Sk of the last tile and past Sq
// of q are zeroed by the threads (no copy fills them); keys past Sk score
// -inf on the last tile only, when Sk is ragged; query rows past Sq are
// computed on zeros and not stored, nor is their lse.  Every output element
// is written once, no atomics: two launches give the same bits.  Rows must
// be aligned to 16 bytes (else the launch is refused).
//
// The launches (launch_f32_d512): one block an item over the whole rounds
// of the card's SMs, then the items left over in a second launch, their key
// tiles split over the kSplit blocks of a cluster (block r takes tiles
// [r n / kSplit, (r + 1) n / kSplit)), each keeping its partial (m, l, O);
// O goes to q's space, and after a cluster barrier block r merges rows
// [r 64 / kSplit, (r + 1) 64 / kSplit) from all the blocks' shared memory
// in rank order (M = max m_s, w_s = 2^(m_s - M), O = sum w_s O_s / sum w_s
// l_s): no atomics and a fixed order, so two launches give the same bits.
// At [25, 3072, 1, 512] the 1200 items are 9 rounds of 132 and 12 left
// over, split 8 ways: a tenth round of 12 blocks would leave 120 SMs idle
// for a whole item (9% of the call).
// ---------------------------------------------------------------------------

constexpr int kW512D = 512;
constexpr int kW512Rows = 64;   // query rows of an item (a block)
constexpr int kW512Warps = 8;   // warp w owns d columns [64w, 64w + 64)
constexpr int kW512BK = 16;     // keys of a tile
// floats a row of q and k in shared memory: 4 of padding put rows 4 banks apart
constexpr int kW512Pitch = kW512D + 4;
constexpr int kW512Region = 132;  // floats of an owner's region of the partials
// S's loop over the slice's 16 steps of 4 d unrolled whole, as P v's 16 keys
constexpr int kW512UnrollD = 16;

template <int kBK>
struct W512Shape {
  static constexpr int kThreads = 32 * kW512Warps;
  static constexpr int kSlice = kW512D / kW512Warps;  // d columns of a warp
  static constexpr int kLanesK = kBK / 4;            // S: lanes along the keys (4 keys each)
  static constexpr int kLanesR = 32 / kLanesK;       // S: lanes along the rows
  static constexpr int kTM = kW512Rows / kLanesR;    // S: a lane's rows
  static constexpr int kOwnRows = kLanesR;           // rows of an owner warp
  static constexpr int kOwners = kW512Rows / kOwnRows;
  static constexpr int kPartFloats = kOwners * kW512Region;  // one warp's partials
  static constexpr int kQFloats = kW512Rows * kW512Pitch;
  static constexpr int kKFloats = kBK * kW512Pitch;
  static constexpr int kVFloats = kBK * kW512D;
  // q, k, v, the partials, then the k and v tiles' two mbarriers
  static constexpr int kFloats = kQFloats + kKFloats + kVFloats + kW512Warps * kPartFloats + 4;
  static_assert(kSlice == 64, "P v: a lane's 8 rows x 16 columns of a 64-wide slice");
  static_assert(kBK == 8 || kBK == 16, "key tiles of 8 or 16");
  static_assert(kOwnRows * kBK <= kW512Region - 4, "an owner's rows fill its region");
  static_assert(kOwners <= kW512Warps && kW512Warps >= 3, "owners; P, alpha, l in three");
  static_assert(kFloats * 4 <= 232448, "a block's shared memory");
  static_assert(kW512Pitch % 4 == 0, "16-byte rows");
};

// the float offset of 16-byte chunk x of row r of q or k in shared memory
__device__ __forceinline__ int w512_off(int r, int x) { return r * kW512Pitch + 4 * x; }

// rows [r0, r0 + n) of one head's 512 columns `src` (row stride ss floats)
// into shared `dst`, `pitch` floats a row: one 2 KB bulk copy a row, issued
// by the lanes of one warp, completing on `bar` (whose expected bytes lane 0
// has set)
__device__ __forceinline__ void w512_load(float* dst, int pitch, const float* src, int64_t ss,
                                          int r0, int n, uint64_t* bar, int lane) {
  for (int r = lane; r < n; r += 32)
    sm90::bulk_load(dst + r * pitch, src + (int64_t)(r0 + r) * ss, kW512D * sizeof(float), bar);
}

// rows [n, R) of shared `dst` (`pitch` floats a row) to zero: the rows past
// an edge, which no copy fills
template <int R, int NT>
__device__ __forceinline__ void w512_zero_rows(float* dst, int pitch, int n, int tid) {
  constexpr int kChunks = kW512D / 4;
  for (int i = tid; i < (R - n) * kChunks; i += NT)
    *reinterpret_cast<float4*>(dst + (n + i / kChunks) * pitch + 4 * (i % kChunks)) =
        make_float4(0.f, 0.f, 0.f, 0.f);
}

#define UNIGEO_W512_PARAMS UNIGEO_F32_PARAMS, int H, int item0
#define UNIGEO_W512_ARGS UNIGEO_F32_ARGS, H, item0

// the body of the three f32w512 kernels; kLse: write the row logsumexp.
// Block i takes item item0 + i / kSplit (query block item % n_qb of head
// item / n_qb % H of batch entry item / (n_qb H)); with kSplit > 1 the
// blocks of a cluster take its key tiles in kSplit ranges and merge.
template <int kBK, int kSplit, bool kLse>
__device__ __forceinline__ void flash_f32w512_block(UNIGEO_W512_PARAMS) {
  using Shape = W512Shape<kBK>;
  constexpr int NT = Shape::kThreads, TM = Shape::kTM, LK = Shape::kLanesK;
  constexpr int LR = Shape::kLanesR, OR = Shape::kOwnRows, RG = kW512Region;
  constexpr int DD = kW512D, SL = Shape::kSlice;
  extern __shared__ __align__(16) float f32w512_smem[];
  float* qs = f32w512_smem;        // [64][516], resident
  float* ks = qs + Shape::kQFloats;  // [kBK][516]
  float* vs = ks + Shape::kKFloats;  // [kBK][512]
  // the partials, warp w's at part + w * kPartFloats, owner o's rows in
  // region o (row 8o + r's slot of keys kc + 4j at 132o + kBK r + 4kc); after
  // the owners' sums, region o of warp 0's area holds P of its rows (key kk,
  // row 8o + r at 132o + 8kk + r), of warp 1's their alpha, of warp 2's, after
  // the last tile, their l
  float* part = vs + Shape::kVFloats;
  float* p_area = part;
  float* alpha_area = part + Shape::kPartFloats;
  float* l_area = part + 2 * Shape::kPartFloats;
  float* m_area = part + 3 * Shape::kPartFloats;  // kSplit > 1: the owners' m, after the last tile
  // the k tile's (and, with tile 0, q's) and the v tile's: one phase a tile
  uint64_t* kbar = reinterpret_cast<uint64_t*>(part + kW512Warps * Shape::kPartFloats);
  uint64_t* vbar = kbar + 1;

  const float scale_log2 = scale;  // the launch passes scale * log2 e
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_qb = (Sq + kW512Rows - 1) / kW512Rows, item = item0 + blockIdx.x / kSplit;
  const int q0 = item % n_qb * kW512Rows, h = item / n_qb % H, b = item / (n_qb * H);
  // this block's key tiles [t0, t0 + n_tiles) of the row's n_all
  const int split = kSplit > 1 ? (int)sm90::cluster_rank() : 0;
  const int n_all = (Sk + kBK - 1) / kBK;
  const int t0 = split * n_all / kSplit, n_tiles = (split + 1) * n_all / kSplit - t0;
  const bool ragged = Sk % kBK != 0;
  const float* qb = q + b * q_sb + (int64_t)h * DD;
  const float* kb = k + b * k_sb + (int64_t)h * DD;
  const float* vb = v + b * v_sb + (int64_t)h * DD;

  const int last = n_all - 1;  // the row's last key tile (the ragged one)
  const auto tile_keys = [&](int t) { return min(kBK, Sk - t * kBK); };
  // k tile t into its slot (warp 0; the last tile's rows past Sk zeroed by
  // every thread), with q's rows where t = t0; the bytes complete on kbar
  const auto issue_k = [&](int t) {
    const int nk = tile_keys(t), nq = t == t0 ? min(kW512Rows, Sq - q0) : 0;
    if (warp == 0) {
      if (lane == 0) sm90::mbar_arrive_expect_tx(kbar, (nk + nq) * kW512D * sizeof(float));
      __syncwarp();
      w512_load(ks, kW512Pitch, kb, k_ss, t * kBK, nk, kbar, lane);
      if (nq > 0) w512_load(qs, kW512Pitch, qb, q_ss, q0, nq, kbar, lane);
    }
    if (nk < kBK) w512_zero_rows<kBK, NT>(ks, kW512Pitch, nk, tid);
    if (nq > 0 && nq < kW512Rows) w512_zero_rows<kW512Rows, NT>(qs, kW512Pitch, nq, tid);
  };
  // v tile t into its slot the same way, on vbar
  const auto issue_v = [&](int t) {
    const int nk = tile_keys(t);
    if (warp == 0) {
      if (lane == 0) sm90::mbar_arrive_expect_tx(vbar, nk * kW512D * sizeof(float));
      __syncwarp();
      w512_load(vs, kW512D, vb, v_ss, t * kBK, nk, vbar, lane);
    }
    if (nk < kBK) w512_zero_rows<kBK, NT>(vs, kW512D, nk, tid);
  };
  if (tid == 0) {
    sm90::mbar_init(kbar, 1);
    sm90::mbar_init(vbar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  issue_k(t0);

  // S: rows rr + LR i, keys kc + LK j of this warp's slice
  const int rr = lane / LK, kc = lane % LK, x0 = warp * (SL / 4);
  // the owner's row 8o + orow (o = warp), keys ok + LK j
  const int orow = lane / LK, ok = lane % LK;
  const bool owner = warp < Shape::kOwners;
  // P v: rows 8pr + i, columns 4(pc + 4jj) + e of this warp's slice; P of
  // those rows (key kk at pw + OR kk), their alpha at aw
  const int pr = lane / 4, pc = lane % 4;
  const int p_reg = 8 * pr / OR * RG + 8 * pr % OR;
  const float* pw = p_area + p_reg;
  const float* aw = alpha_area + p_reg;
  const float* vc = vs + warp * SL + 4 * pc;

  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[i][c] = 0.f;
  float m = -INFINITY, l = 0.f;  // the owner's row: running max (log2 units), its keys' share of l

  for (int it = 0; it < n_tiles; ++it) {
    const int t = t0 + it;
    __syncthreads();  // (T) P v(it - 1) is done: v and the partials are free
    issue_v(t);
    sm90::mbar_wait(kbar, it & 1);  // k(it) (and q) have landed

    // S_w for rows rr + LR i, keys kc + LK j, in the order of d
    float s[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll (kW512UnrollD)
    for (int c = 0; c < SL / 4; ++c) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + w512_off(kc + LK * j, x0 + c));
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + w512_off(rr + LR * i, x0 + c));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }
    // the partials out: row rr + LR i is owner i's row rr
    float* mine = part + warp * Shape::kPartFloats + kBK * rr + 4 * kc;
#pragma unroll
    for (int i = 0; i < TM; ++i)
      *reinterpret_cast<float4*>(mine + i * RG) = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    __syncthreads();  // (A) every partial is written; every warp has read k(it)
    if (it + 1 < n_tiles) issue_k(t + 1);

    if (owner) {
      // S of row 8o + orow, keys ok + LK j: the 8 partials in warp order
      const float* src = part + warp * RG + kBK * orow + 4 * ok;
      float4 x = *reinterpret_cast<const float4*>(src);
#pragma unroll
      for (int w = 1; w < kW512Warps; ++w) {
        const float4 y = *reinterpret_cast<const float4*>(src + w * Shape::kPartFloats);
        x = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
      }
      float sc[4] = {x.x, x.y, x.z, x.w};
      // the row's online softmax in log2 units, where keys past Sk (zero
      // rows of the ragged last tile) score -inf
      if (ragged && t == last) {
        const int lim = Sk - t * kBK;
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[j] = ok + LK * j < lim ? sc[j] : -INFINITY;
      }
      float mx = fmaxf(fmaxf(sc[0], sc[1]), fmaxf(sc[2], sc[3]));
#pragma unroll
      for (int off = 1; off < LK; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m, mx * scale_log2);  // finite: each tile has a key
      const float alpha = exp2_approx(m - m_new);
      m = m_new;
      l *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[j] = exp2_approx(fmaf(sc[j], scale_log2, -m_new));
        l += sc[j];
      }
      __syncwarp();  // the warp's lanes have read their partials where P goes
      float* preg = p_area + warp * RG + orow;
#pragma unroll
      for (int j = 0; j < 4; ++j) preg[(ok + LK * j) * OR] = sc[j];
      if (ok == 0) alpha_area[warp * RG + orow] = alpha;
    }
    sm90::mbar_wait(vbar, it & 1);  // v(it) has landed
    __syncthreads();                // (C) P, alpha and v(it)'s zero rows are visible

    // O = alpha O + P v for rows 8pr + i, this warp's columns
    {
      const float4 a0 = *reinterpret_cast<const float4*>(aw);
      const float4 a1 = *reinterpret_cast<const float4*>(aw + 4);
      const float al[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[i][c] *= al[i];
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p0 = *reinterpret_cast<const float4*>(pw + OR * kk);
      const float4 p1 = *reinterpret_cast<const float4*>(pw + OR * kk + 4);
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float4 vv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        vv[jj] = *reinterpret_cast<const float4*>(vc + kk * DD + 16 * jj);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[i][4 * jj] = fmaf(pv[i], vv[jj].x, acc[i][4 * jj]);
          acc[i][4 * jj + 1] = fmaf(pv[i], vv[jj].y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(pv[i], vv[jj].z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(pv[i], vv[jj].w, acc[i][4 * jj + 3]);
        }
    }
  }

  // l over the row's lanes; the owners' l (and m where the keys split, or
  // the lse) out
  if (owner) {
#pragma unroll
    for (int off = 1; off < LK; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const int row = q0 + warp * OR + orow;
    if (ok == 0) {
      l_area[warp * RG + orow] = l;
      if (kSplit > 1) m_area[warp * RG + orow] = m;
      else if (kLse && row < Sq) lse[((int64_t)b * H + h) * Sq + row] = kLn2 * (m + log2f(l));
    }
  }
  if constexpr (kSplit == 1) {
    __syncthreads();
    const float* lw = l_area + p_reg;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + 8 * pr + i;
      if (row >= Sq) continue;
      const float inv = 1.f / lw[i];
      float* orow_p = o + b * o_sb + row * o_ss + (int64_t)h * DD + warp * SL + 4 * pc;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        *reinterpret_cast<float4*>(orow_p + 16 * jj) =
            make_float4(acc[i][4 * jj] * inv, acc[i][4 * jj + 1] * inv, acc[i][4 * jj + 2] * inv,
                        acc[i][4 * jj + 3] * inv);
    }
  } else {
    // the partial O over q's rows (S is done everywhere), then block r
    // merges rows [r R, (r + 1) R) from every block's partials in rank order:
    // M = max m_s, w_s = 2^(m_s - M), O = sum w_s O_s / sum w_s l_s
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        *reinterpret_cast<float4*>(qs + (8 * pr + i) * kW512Pitch + warp * SL + 4 * pc +
                                   16 * jj) =
            make_float4(acc[i][4 * jj], acc[i][4 * jj + 1], acc[i][4 * jj + 2], acc[i][4 * jj + 3]);
    sm90::cluster_sync();  // every block's partials are written
    constexpr int R = kW512Rows / kSplit, kChunks = DD / 4;
    for (int c = tid; c < R * kChunks; c += NT) {
      const int r = split * R + c / kChunks, x = c % kChunks, row = q0 + r;
      const int reg = r / OR * RG + r % OR;  // row r's slot of l and m
      float ms[kSplit], mx = -INFINITY;
#pragma unroll
      for (int sp = 0; sp < kSplit; ++sp) {
        ms[sp] = sm90::ld_cluster_f32(m_area + reg, sp);
        mx = fmaxf(mx, ms[sp]);
      }
      float lsum = 0.f;
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int sp = 0; sp < kSplit; ++sp) {  // rank order
        const float w = exp2_approx(ms[sp] - mx);
        const float4 a = sm90::ld_cluster_f32x4(qs + r * kW512Pitch + 4 * x, sp);
        lsum = fmaf(w, sm90::ld_cluster_f32(l_area + reg, sp), lsum);
        y = make_float4(fmaf(w, a.x, y.x), fmaf(w, a.y, y.y), fmaf(w, a.z, y.z),
                        fmaf(w, a.w, y.w));
      }
      if (row < Sq) {
        const float inv = 1.f / lsum;
        *reinterpret_cast<float4*>(o + b * o_sb + row * o_ss + (int64_t)h * DD + 4 * x) =
            make_float4(y.x * inv, y.y * inv, y.z * inv, y.w * inv);
        if (kLse && x == 0) lse[((int64_t)b * H + h) * Sq + row] = kLn2 * (mx + log2f(lsum));
      }
    }
    sm90::cluster_sync();  // no block leaves while another reads its partials
  }
}

// one kernel per entry point, so a profile tells them apart by name; the
// scale arrives in log2 units (scale * log2 e)
template <int kBK, int kSplit>
__global__ void __launch_bounds__(W512Shape<kBK>::kThreads, 1)
    flash_packed_f32w512_kernel(UNIGEO_W512_PARAMS) {
  flash_f32w512_block<kBK, kSplit, false>(UNIGEO_W512_ARGS);
}

template <int kBK, int kSplit>
__global__ void __launch_bounds__(W512Shape<kBK>::kThreads, 1)
    flash_headsplit_f32w512_kernel(UNIGEO_W512_PARAMS) {
  flash_f32w512_block<kBK, kSplit, false>(UNIGEO_W512_ARGS);
}

template <int kBK, int kSplit>
__global__ void __launch_bounds__(W512Shape<kBK>::kThreads, 1)
    flash_fwd_lse_f32w512_kernel(UNIGEO_W512_PARAMS) {
  flash_f32w512_block<kBK, kSplit, true>(UNIGEO_W512_ARGS);
}

#undef UNIGEO_W512_PARAMS
#undef UNIGEO_W512_ARGS

// q, k, v and o contiguous [B, S, H*D] (the tensor maps and the stores
// assume it)
bool packed_contiguous(int64_t hd, int Sq, int Sk, int64_t q_sb, int64_t q_ss, int64_t k_sb,
                       int64_t k_ss, int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss) {
  return q_ss == hd && k_ss == hd && v_ss == hd && o_ss == hd && q_sb == Sq * hd &&
         o_sb == Sq * hd && k_sb == Sk * hd && v_sb == Sk * hd;
}

// the three tensor maps of a launch: boxes of W columns, q's of bq rows,
// k's and v's of bk rows
cudaError_t qkv_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv, const void* q,
                     const void* k, const void* v, int B, int Sq, int Sk, int hd, int W, int bq,
                     int bk) {
  const CUtensorMapSwizzle swz = W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_32B;
  cudaError_t err;
  if ((err = sm90::packed_tile_map(tq, q, B, Sq, hd, W, bq, swz)) != cudaSuccess ||
      (err = sm90::packed_tile_map(tk, k, B, Sk, hd, W, bk, swz)) != cudaSuccess)
    return err;
  return sm90::packed_tile_map(tv, v, B, Sk, hd, W, bk, swz);
}

// anything but contiguous [B, S, H*D] rows is refused
template <int D>
cudaError_t launch_wgmma(Entry entry, const void* q, const void* k, const void* v, void* o,
                         float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                         int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                         int B, int Sq, int Sk, int H, float scale, cudaStream_t stream) {
  const int64_t hd = (int64_t)H * D;
  if (!packed_contiguous(hd, Sq, Sk, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  using Shape = WgShape<D>;
  cudaError_t err = qkv_maps(&tq, &tk, &tv, q, k, v, B, Sq, Sk, (int)hd, kBoxW<D>,
                             Shape::kBlockQ, Shape::kBlockK);
  if (err != cudaSuccess) return err;
  auto kern = entry == kFwdLse      ? flash_fwd_lse_wgmma_kernel<D>
              : entry == kHeadsplit ? flash_headsplit_wgmma_kernel<D>
                                    : flash_packed_wgmma_kernel<D>;
  constexpr size_t smem = sizeof(WgSmem<D>) + 1024;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // at most one block per SM, walking over the items
  const int64_t items = (int64_t)((Sq + Shape::kBlockQ - 1) / Shape::kBlockQ) * H * B;
  if (items > INT32_MAX) return cudaErrorInvalidValue;
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int blocks = items < sms ? (int)items : sms;
  kern<<<blocks, Shape::kThreads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o),
                                                  lse, Sq, Sk, H, B, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t launch_wgmma512(Entry entry, const void* q, const void* k, const void* v, void* o,
                            float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                            int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                            int B, int Sq, int Sk, int H, float scale, cudaStream_t stream) {
  const int64_t hd = (int64_t)H * kW5D;
  if (!packed_contiguous(hd, Sq, Sk, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = qkv_maps(&tq, &tk, &tv, q, k, v, B, Sq, Sk, (int)hd, 64, kW5Rows,
                             kW5BlockK);
  if (err != cudaSuccess) return err;
  auto kern = entry == kFwdLse      ? flash_fwd_lse_wgmma512_kernel
              : entry == kHeadsplit ? flash_headsplit_wgmma512_kernel
                                    : flash_packed_wgmma512_kernel;
  constexpr size_t smem = sizeof(W5Smem) + 1024;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kW5Rows - 1) / kW5Rows, H, B);
  kern<<<grid, kW5Threads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse,
                                           Sq, Sk, H, B, scale * kLog2e);
  return cudaGetLastError();
}

// The bf16 forward's one switch, by shape alone: the wgmma body of 64-row
// consumers at the UNet's 64, CLIP's 80 (and 16 for small checks), the
// column-split wgmma body at the VAE's 512, each for rows aligned to 16
// bytes; every other width up to 512, and rows the TMA cannot take (not
// aligned to 16 bytes), to the CUDA-core body flash_f32_block<__nv_bfloat16>,
// every width past 512 to flash_wide_block<__nv_bfloat16>.
// A launch a body refuses returns its error: no other body is tried.
cudaError_t dispatch_bf16(Entry entry, const void* q, const void* k, const void* v, void* o,
                          float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                          int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                          int B, int Sq, int Sk, int H, int D, float scale,
                          cudaStream_t stream) {
  const bool wgmma_width = D == 16 || D == 64 || D == 80 || D == kW5D;
  if (!wgmma_width || !aligned16(q, k, v, o, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, 8))
    return launch_cuda_core<__nv_bfloat16>(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss,
                                           v_sb, v_ss, o_sb, o_ss, B, Sq, Sk, H, D, scale,
                                           stream);
#define UNIGEO_WG(DD)                                                                    \
  case DD:                                                                               \
    return launch_wgmma<DD>(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,  \
                            o_sb, o_ss, B, Sq, Sk, H, scale, stream);
  switch (D) {
    UNIGEO_WG(16)
    UNIGEO_WG(64)
    UNIGEO_WG(80)
    case kW5D:
      return launch_wgmma512(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb,
                             o_ss, B, Sq, Sk, H, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
#undef UNIGEO_WG
}

// The f32 body at D = 64: blocks of kRegWarps warps (16 query rows each),
// 64-key tiles in a ring of kRegStages slots; where the items of one block
// each do not give every SM one, the keys split over clusters of 2 or 4
// blocks (launch_f32_d64).  The measured choices of
// tools/forward_variants.py --f32.
constexpr int kRegWarps = 4, kRegStages = 2;

template <int kSplit>
cudaError_t launch_f32reg(Entry entry, const void* q, const void* k, const void* v, void* o,
                          float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                          int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss, int B,
                          int Sq, int Sk, int H, float scale, cudaStream_t stream) {
  using Shape = RegShape<kRegWarps, kRegStages, kSplit>;
  auto kern = entry == kFwdLse      ? flash_fwd_lse_f32reg_kernel<kRegWarps, kRegStages, kSplit>
              : entry == kHeadsplit ? flash_headsplit_f32reg_kernel<kRegWarps, kRegStages, kSplit>
                                    : flash_packed_f32reg_kernel<kRegWarps, kRegStages, kSplit>;
  constexpr size_t smem = Shape::kFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Sq + Shape::kRows - 1) / Shape::kRows * kSplit, H, B);
  cfg.blockDim = dim3(Shape::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kSplit > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const float*>(q),
                           static_cast<const float*>(k), static_cast<const float*>(v),
                           static_cast<float*>(o), lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                           o_sb, o_ss, Sq, Sk, kRegD, scale * kLog2e);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the plan at D = 64: one block an item where the items give every SM one
// (or there is a single key tile); else the keys split over clusters of 2,
// or of 4 where two would still leave SMs idle and there are 4 key tiles
// or more
cudaError_t launch_f32_d64(Entry entry, const void* q, const void* k, const void* v, void* o,
                           float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                           int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss, int B,
                           int Sq, int Sk, int H, float scale, cudaStream_t stream) {
  if (!aligned16(q, k, v, o, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, 4))
    return cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  constexpr int rows = RegShape<kRegWarps, kRegStages, 1>::kRows;
  const int64_t items = (int64_t)((Sq + rows - 1) / rows) * H * B;
  const int n_tiles = (Sk + kRegBK - 1) / kRegBK;
#define UNIGEO_REG(KS)                                                                   \
  launch_f32reg<KS>(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, \
                    B, Sq, Sk, H, scale, stream)
  if (items >= sms || n_tiles < 2) return UNIGEO_REG(1);
  if (2 * items >= sms || n_tiles < 4) return UNIGEO_REG(2);
  return UNIGEO_REG(4);
#undef UNIGEO_REG
}

// `items` items of the f32 body at D = 512 from item0 on, each over the
// kSplit blocks of a cluster
template <int kSplit>
cudaError_t launch_f32w512(Entry entry, const void* q, const void* k, const void* v, void* o,
                           float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                           int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss, int Sq,
                           int Sk, int H, float scale, int item0, int items,
                           cudaStream_t stream) {
  using Shape = W512Shape<kW512BK>;
  auto kern = entry == kFwdLse      ? flash_fwd_lse_f32w512_kernel<kW512BK, kSplit>
              : entry == kHeadsplit ? flash_headsplit_f32w512_kernel<kW512BK, kSplit>
                                    : flash_packed_f32w512_kernel<kW512BK, kSplit>;
  constexpr size_t smem = Shape::kFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(items * kSplit);
  cfg.blockDim = dim3(Shape::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kSplit > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const float*>(q),
                           static_cast<const float*>(k), static_cast<const float*>(v),
                           static_cast<float*>(o), lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                           o_sb, o_ss, Sq, Sk, kW512D, scale * kLog2e, H, item0);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The f32 body at D = 512, rows aligned to 16 bytes: one block an item
// (64 query rows of one batch entry and head) over the whole rounds of the
// card's SMs, then the items left over (fewer than the SMs) in a second
// launch, their keys split over clusters of 8 blocks where the SMs hold
// them all and each keeps a key tile.  At [25, 3072, 1, 512] the 1200 items
// are 9 rounds of 132 and 12 left over, split 8 ways: a tenth round of 12
// blocks would leave 120 SMs idle for a whole item.  (Each split is 3 more
// fully unrolled kernels to build: the path needs 8.)
cudaError_t launch_f32_d512(Entry entry, const void* q, const void* k, const void* v, void* o,
                            float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                            int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss, int B,
                            int Sq, int Sk, int H, float scale, cudaStream_t stream) {
  if (!aligned16(q, k, v, o, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, 4))
    return cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int64_t items = (int64_t)((Sq + kW512Rows - 1) / kW512Rows) * H * B;
  if (items > INT32_MAX) return cudaErrorInvalidValue;
  const int whole = (int)(items / sms * sms), rest = (int)(items - whole);
  const int n_tiles = (Sk + kW512BK - 1) / kW512BK;
#define UNIGEO_W512(KS, I0, N)                                                            \
  launch_f32w512<KS>(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, \
                     Sq, Sk, H, scale, I0, N, stream)
  if (whole > 0 && (err = UNIGEO_W512(1, 0, whole)) != cudaSuccess) return err;
  if (rest == 0) return cudaSuccess;
  constexpr int kSplit = 8;
  if (rest * kSplit <= sms && kSplit <= n_tiles) return UNIGEO_W512(kSplit, whole, rest);
  return UNIGEO_W512(1, whole, rest);
#undef UNIGEO_W512
}

// The f32 forward's one switch by head width: D = 64 (the pointmap path)
// and D = 512 (the VAE mid block's head) go to their register-tiled bodies,
// which take rows aligned to 16 bytes (else the launch is refused); every
// other width up to 512 (the checks' 8, 10, 32 and 80, the tiny pointmap
// configs' 24 and 32) to flash_f32_block<float> as before, and every width
// past 512 to flash_wide_block<float>.  No width is sent to another body.
cudaError_t dispatch_f32(Entry entry, const void* q, const void* k, const void* v, void* o,
                         float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                         int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                         int B, int Sq, int Sk, int H, int D, float scale,
                         cudaStream_t stream) {
  if (D == kRegD)
    return launch_f32_d64(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb,
                          o_ss, B, Sq, Sk, H, scale, stream);
  if (D == kW512D)
    return launch_f32_d512(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb,
                           o_ss, B, Sq, Sk, H, scale, stream);
  return launch_cuda_core<float>(entry, q, k, v, o, lse, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                                 o_sb, o_ss, B, Sq, Sk, H, D, scale, stream);
}

}  // namespace

namespace {

cudaError_t dispatch(Entry entry, const void* q, const void* k, const void* v, void* o,
                     float* lse, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                     int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                     int B, int Sq, int Sk, int H, int D, float scale, int dtype,
                     void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || D <= 0 || H > 65535 || B > 65535)
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
