// Packed flash-attention backward for Hopper (sm_90a): two kernels.
//
// Replaces: unigeo_tpu/ops/attention.py:582 flash_attention_tpu_bwd, whose
// two pallas_calls are the dq kernel (:624, _flash_bwd_dq_kernel) and the
// dk/dv kernel (:641, _flash_bwd_dkv_kernel): the backward of the
// differentiable packed attention (attention.py::attention_packed).  For
// each batch b and head h, with head h the column slice [h*D, (h+1)*D) of
// the packed [B, S, H*D] rows of q, k, v, dO and of the outputs:
//
//   S = q k^T * scale,  P = exp(S - lse)            (lse from the forward)
//   dP = dO v^T,        dS = P o (dP - delta) * scale
//   dq = dS k,          dk = dS^T q,          dv = P^T dO
//
// delta = rowsum(dO o O) [B, H, Sq] f32 comes in from the caller, as the
// JAX package computes it outside its kernels; lse is the forward's
// [B, H, Sq] f32.  Neither kernel writes S, P or dS to device memory:
//
// * dq kernel: one block per (192 queries, head, batch), looping over key
//   tiles; recomputes S and dP for its rows and accumulates dq.
// * dk/dv kernel: one block per (128 keys, head, batch), looping over query
//   tiles; recomputes S^T and dP^T for its keys and accumulates dk and dv.
//
// Every output element is written by one block, once: no atomics, and two
// launches give the same bits.  The price is that each kernel recomputes S
// and dP, so the pair does 7 products of Sq x Sk x D where the gradient
// needs 5 (S, dP, dq, dk, dv); it is kept for determinism, as the JAX
// package's two kernels keep it.
//
// What bounds it on the H100 at the training path's shapes (batch 25, the
// frames of a clip): the 5 products' 10*B*H*Sq*Sk*D operations against
// about 2*B*D*H*(4*Sq + 4*Sk) bytes in bf16 (q, k, v, dO read, dq, dk, dv
// written; lse and delta add 8 bytes a row).  Operations bound it at the
// UNet's stages 0 and 1 (Sq = Sk = 3072 and 768: about 3800 and 950
// operations a byte, above the ~295 where the tensor cores become the
// limit), bytes at stage 2 (192 tokens, about 240 a byte).
//
// bf16, any other D up to 128 (CLIP's 80 when a trainer unfreezes it, the
// tiny pointmap configs' 24 and 32), and bases not aligned to 16 bytes at
// any width (the TMA cannot take them): the CUDA-core body of the f32
// section below instantiated for bf16, bwd_{dq,dkv}_f32_kernel<__nv_bfloat16,
// NCOL>.  It reads bf16 into f32 and does every product and sum in f32 (P
// and dS are not rounded to bf16, as the wgmma bodies round them); each
// gradient is rounded to bf16 once.  No shape reaches it on a default path.
//
// bf16, D in {16, 64} (the UNet's 64, and 16 for small checks): what the
// design does about that bound.
//
// * The tensor cores through wgmma (sm90.cuh), the only way to their full
//   rate on Hopper, for all five products, f32 accumulate.  S and dP take
//   both operands from shared memory (the consumer's resident 64 rows as A,
//   the slot's tile as B, both K-major); P^T and dS^T (dS for dq) go from
//   the accumulator layout straight to the A-register layout of the next
//   product, whose B is the slot's tile read MN-major (the transpose bit),
//   rounded to bf16 as the Pallas kernels round them: P before dv = P^T dO,
//   dS before dq = dS k and dk = dS^T q.
// * Warp-specialised blocks: a producer warpgroup and two (dk/dv) or three
//   (dq) consumers.  One thread of the producer keeps the TMA (3-D tensor maps over the packed layout, one
//   64-row box of one head per load, 128- or 32-byte swizzled to match the
//   wgmma descriptors) filling a ring of kStages slots under full / empty
//   mbarriers, so the loads of the next tiles overlap the products on this
//   one; the producer hands its registers to the consumers (setmaxnreg).
//   Each consumer owns 64 of the block's rows and runs on its own; the
//   consumers interleave on the SM, one's exponentials under another's
//   products.  P's mask is a select and its exponential one SFU ex2.approx
//   (2 ulp, under the limits' allowance for the kernel's exp2).
// * 128- and 192-row blocks: each tile brought from L2 serves 128 keys
//   (dk/dv) or 192 queries (dq), 1/2 and 1/3 of the L2 traffic per row of
//   64-row blocks.
// * Ragged edges: the TMA returns zeros for rows past S, so no load leaves
//   the tensor, the loops run to the last partial tile, and the zero rows
//   add nothing (a zero key row adds dS * 0 to dq, a zero query row P * 0
//   to dv and dS * 0 to dk, though P = exp(-lse) != 0 there).  The kernels
//   still set P = 0 for keys past Sk (dq) and queries past Sq (dk/dv), so
//   no row past the edge can reach a sum, and store no row past Sq / Sk.
//
// f32: CUDA-core FMAs, exact f32 (no tensor core, so no TF32), the numerics
// of the f32 training paths (Spann3R, Dust3R, Cut3R, VideoDepthAnything and
// Aether, all at D = 64).  What bounds the pair there: the 7 products'
// 14*B*H*Sq*Sk*D operations at the CUDA cores' 67 TF/s against
// 4*B*H*D*(5*Sq + 6*Sk) bytes (each kernel reads q, k, v and dO, dq writes
// dq, dk/dv writes dk and dv; lse and delta add 8 bytes a query row to
// each): 244 operations a byte at 768 tokens and 41 at Cut3R's 768 queries
// over 64 keys, above the 20 at which the FMA units rather than memory
// become the limit, so operations bound every training shape.  Two bodies,
// one switch by head width (dispatch):
//
// * D = 64: bwd_{dq,dkv}_f32reg_kernel<kWarps, kStages, kSplit>, register-
//   tiled and fed by a cp.async ring (see its section below).  What held
//   the earlier body to 17-20% of the f32 rate was shared memory, one 4-byte
//   load per FMA; these load 16 bytes for 10.7 FMAs, hide the copies under
//   the products, and split the looped tiles over a cluster where the items
//   leave SMs idle.  Rows must be aligned to 16 bytes (else the launch is
//   refused).
// * any other D up to 128 (the checks' 8, 16, 32 and 128):
//   bwd_{dq,dkv}_f32_kernel<float, NCOL>.  256 threads own 64 rows, four lanes a
//   row, each lane holding 16 scores of a 64-wide tile and D/4 columns of
//   the accumulators; tile loads clamp their row index to the last valid
//   row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ int clamp_row(int s, int S) { return s < S ? s : S - 1; }

// 2^x by the SFU (ex2.approx.ftz: 2 ulp, results below 2^-126 flushed to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// f32, CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32Tile = 64;                          // rows of either tile
constexpr int kF32Lanes = kF32Threads / kF32Tile;     // 4 lanes per row
constexpr int kF32PerLane = kF32Tile / kF32Lanes;     // 16 scores per lane

// the CUDA-core bodies' element type T: float, or __nv_bfloat16 read into
// f32 on load and rounded to bf16 once on the store
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

// rows [s0, s0 + kF32Tile) of a packed head into shared memory (pitch D+1),
// in f32, row indices clamped to S-1
template <typename T>
__device__ __forceinline__ void load_rows_f32(float* dst, const T* src, int64_t ss,
                                              int s0, int S, int D, int tid) {
  const int dp = D + 1;
  for (int i = tid; i < kF32Tile * D; i += kF32Threads) {
    const int r = i / D, d = i % D;
    dst[r * dp + d] = to_f32(src[(int64_t)clamp_row(s0 + r, S) * ss + d]);
  }
}

size_t f32_smem_bytes(int D, int n_ptiles) {
  // four [64][D+1] tiles and n_ptiles [64][65] score tiles, plus 2 x 64 row values
  return sizeof(float) * (4 * (size_t)kF32Tile * (D + 1) +
                          (size_t)n_ptiles * kF32Tile * (kF32Tile + 1) + 2 * kF32Tile);
}

// T = float, or __nv_bfloat16 (every product and sum in f32, P and dS not
// rounded; each gradient rounded to bf16 once)
template <typename T, int NCOL>
__global__ void __launch_bounds__(kF32Threads)
bwd_dq_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dq, int Sq, int Sk, int D, float scale) {
  extern __shared__ float smem[];
  const int dp = D + 1, pp = kF32Tile + 1;
  float* qs = smem;                    // [64][D+1]
  float* dos = qs + kF32Tile * dp;     // [64][D+1]
  float* ks = dos + kF32Tile * dp;     // [64][D+1]
  float* vs = ks + kF32Tile * dp;      // [64][D+1]
  float* dss = vs + kF32Tile * dp;     // [64][65]

  const int tid = threadIdx.x, row = tid / kF32Lanes, lane = tid % kF32Lanes;
  const int q0 = blockIdx.x * kF32Tile, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int64_t hd = (int64_t)H * D;
  const int64_t hoff = (int64_t)h * D;
  const T* qb = q + (int64_t)b * Sq * hd + hoff;
  const T* dob = dout + (int64_t)b * Sq * hd + hoff;
  const T* kb = k + (int64_t)b * Sk * hd + hoff;
  const T* vb = v + (int64_t)b * Sk * hd + hoff;

  load_rows_f32(qs, qb, hd, q0, Sq, D, tid);
  load_rows_f32(dos, dob, hd, q0, Sq, D, tid);
  const int64_t rid = ((int64_t)b * H + h) * Sq + clamp_row(q0 + row, Sq);
  const float lse_r = lse[rid], delta_r = delta[rid];

  float acc[NCOL];
#pragma unroll
  for (int j = 0; j < NCOL; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kF32Tile) {
    __syncthreads();  // previous key tile consumed (and q, dO loaded)
    load_rows_f32(ks, kb, hd, k0, Sk, D, tid);
    load_rows_f32(vs, vb, hd, k0, Sk, D, tid);
    __syncthreads();

    float sc[kF32PerLane], dpv[kF32PerLane];
#pragma unroll
    for (int j = 0; j < kF32PerLane; ++j) sc[j] = dpv[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[row * dp + d], dov = dos[row * dp + d];
#pragma unroll
      for (int j = 0; j < kF32PerLane; ++j) {
        const int kk = lane + j * kF32Lanes;
        sc[j] = fmaf(qv, ks[kk * dp + d], sc[j]);
        dpv[j] = fmaf(dov, vs[kk * dp + d], dpv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kF32PerLane; ++j) {
      const int kk = lane + j * kF32Lanes;
      const float p = k0 + kk < Sk ? expf(sc[j] * scale - lse_r) : 0.f;
      dss[row * pp + kk] = p * (dpv[j] - delta_r) * scale;
    }
    __syncwarp();  // the row's dS was written by lanes of this warp

    const float* dsrow = dss + row * pp;
    for (int kk = 0; kk < kF32Tile; ++kk) {
      const float ds = dsrow[kk];
      const float* krow = ks + kk * dp;
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        const int c = lane + j * kF32Lanes;
        if (c < D) acc[j] = fmaf(ds, krow[c], acc[j]);
      }
    }
  }

  const int s = q0 + row;
  if (s < Sq) {
    T* out = dq + (int64_t)b * Sq * hd + (int64_t)s * hd + hoff;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int c = lane + j * kF32Lanes;
      if (c < D) out[c] = from_f32<T>(acc[j]);
    }
  }
}

template <typename T, int NCOL>
__global__ void __launch_bounds__(kF32Threads)
bwd_dkv_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dk, T* __restrict__ dv,
                   int Sq, int Sk, int D, float scale) {
  extern __shared__ float smem[];
  const int dp = D + 1, pp = kF32Tile + 1;
  float* ks = smem;                    // [64][D+1]
  float* vs = ks + kF32Tile * dp;      // [64][D+1]
  float* qs = vs + kF32Tile * dp;      // [64][D+1]
  float* dos = qs + kF32Tile * dp;     // [64][D+1]
  float* ps = dos + kF32Tile * dp;     // [64][65]  P^T of this key row
  float* dss = ps + kF32Tile * pp;     // [64][65]  dS^T
  float* lses = dss + kF32Tile * pp;   // [64]
  float* deltas = lses + kF32Tile;     // [64]

  const int tid = threadIdx.x, row = tid / kF32Lanes, lane = tid % kF32Lanes;
  const int k0 = blockIdx.x * kF32Tile, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int64_t hd = (int64_t)H * D;
  const int64_t hoff = (int64_t)h * D;
  const T* qb = q + (int64_t)b * Sq * hd + hoff;
  const T* dob = dout + (int64_t)b * Sq * hd + hoff;
  const T* kb = k + (int64_t)b * Sk * hd + hoff;
  const T* vb = v + (int64_t)b * Sk * hd + hoff;
  const float* lseb = lse + ((int64_t)b * H + h) * Sq;
  const float* deltab = delta + ((int64_t)b * H + h) * Sq;

  load_rows_f32(ks, kb, hd, k0, Sk, D, tid);
  load_rows_f32(vs, vb, hd, k0, Sk, D, tid);

  float acc_k[NCOL], acc_v[NCOL];
#pragma unroll
  for (int j = 0; j < NCOL; ++j) acc_k[j] = acc_v[j] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += kF32Tile) {
    __syncthreads();  // previous query tile consumed (and k, v loaded)
    load_rows_f32(qs, qb, hd, q0, Sq, D, tid);
    load_rows_f32(dos, dob, hd, q0, Sq, D, tid);
    for (int i = tid; i < kF32Tile; i += kF32Threads) {
      const int s = clamp_row(q0 + i, Sq);
      lses[i] = lseb[s];
      deltas[i] = deltab[s];
    }
    __syncthreads();

    float sc[kF32PerLane], dpv[kF32PerLane];
#pragma unroll
    for (int j = 0; j < kF32PerLane; ++j) sc[j] = dpv[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kv = ks[row * dp + d], vv = vs[row * dp + d];
#pragma unroll
      for (int j = 0; j < kF32PerLane; ++j) {
        const int qi = lane + j * kF32Lanes;
        sc[j] = fmaf(kv, qs[qi * dp + d], sc[j]);
        dpv[j] = fmaf(vv, dos[qi * dp + d], dpv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kF32PerLane; ++j) {
      const int qi = lane + j * kF32Lanes;
      const float p = q0 + qi < Sq ? expf(sc[j] * scale - lses[qi]) : 0.f;
      ps[row * pp + qi] = p;
      dss[row * pp + qi] = p * (dpv[j] - deltas[qi]) * scale;
    }
    __syncwarp();  // the row's P and dS were written by lanes of this warp

    const float* prow = ps + row * pp;
    const float* dsrow = dss + row * pp;
    for (int qi = 0; qi < kF32Tile; ++qi) {
      const float p = prow[qi], ds = dsrow[qi];
      const float* dorow = dos + qi * dp;
      const float* qrow = qs + qi * dp;
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        const int c = lane + j * kF32Lanes;
        if (c < D) {
          acc_v[j] = fmaf(p, dorow[c], acc_v[j]);
          acc_k[j] = fmaf(ds, qrow[c], acc_k[j]);
        }
      }
    }
  }

  const int s = k0 + row;
  if (s < Sk) {
    const int64_t off = (int64_t)b * Sk * hd + (int64_t)s * hd + hoff;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int c = lane + j * kF32Lanes;
      if (c < D) {
        dk[off + c] = from_f32<T>(acc_k[j]);
        dv[off + c] = from_f32<T>(acc_v[j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 at D = 64 (the f32 training paths): register-tiled CUDA-core bodies
// fed by a cp.async ring, bwd_dq_f32reg_kernel and bwd_dkv_f32reg_kernel
// <kWarps, kStages, kSplit>.  Exact f32: every product and sum is an f32 FMA
// or add on the CUDA cores (no tensor core, so no TF32), P one SFU ex2 in
// log2 units (the score times scale log2 e, less lse log2 e).
//
// A block owns kRows = 16 kWarps rows of one (batch, head), resident in
// shared memory with their partner: query rows with dO (dq), key rows with
// v (dk/dv); 64-row tiles of the other side stream through a ring.  A warp
// owns 16 rows whole; lane (rg, cl) = (lane / 8, lane % 8) holds rows
// rg + 4i (i < 4) of its warp's, the scores of the streamed rows cl + 8j
// (j < 8) of each tile, and the accumulator columns [4cl, 4cl + 4) and
// [32 + 4cl, 36 + 4cl).
//
// * dq: per key tile, S = q k^T and dP = dO v^T as 4 x 8 register tiles fed
//   by 16-byte loads along d (4 q and 8 k loads feed 128 FMAs, 10.7 a load);
//   P = 2^(S scale log2 e - lse log2 e), 0 for keys past Sk; dS = P (dP scale
//   - delta scale).  dS goes through the warp's own [64][16] buffer (a
//   lane's 4 rows of key kk in one 16-byte slot, XOR-swizzled by kk so a
//   quarter-warp's 8 stores fall in distinct banks), and dq += dS k takes
//   one dS load and two k loads per 32 FMAs.
// * dk/dv: the same, transposed.  S^T = k q^T, P^T (0 for queries past Sq)
//   into the buffer, dv += P^T dO; then dP^T = v dO^T and dS^T = P^T (dP^T
//   scale - delta scale), P^T read back from the lane's own slots, dS^T into
//   the buffer, dk += dS^T q.  A lane holds dk and dv (64 floats) and one
//   score tile at a time, not the 128 floats of both tiles and both
//   accumulators.  lse and delta of the lane's 8 queries of a tile are read
//   from device memory (L2) before S^T, whose products hide the latency;
//   rows past Sq are never read.
// * Layout: every tile is [rows][64] f32, its 16-byte chunks XOR-swizzled by
//   the row's low 3 bits (swz).  The 8 rows cl + 8j that a quarter-warp
//   reads at one d, the 4 rows rg + 4i that a warp reads, and the 8 chunks
//   of a row that the update reads each fall in distinct banks, with no
//   padding: a block of 4 warps takes 112 KB, and two share an SM.
// * Copies: every thread issues 16-byte cp.async (L2 only) for its share of
//   the resident rows (once) and of each streamed tile into a ring of
//   kStages slots, one commit group per tile; at tile it a thread waits for
//   its own group, one __syncthreads makes every thread's copies visible
//   and frees the slot of tile it - 1, which then takes tile it + kStages -
//   1 while tile it is computed.  cp.async and not the TMA, as in the f32
//   forward: the TMA's swizzles are patterns for 16-bit tensor-core tiles,
//   not the one these loads need.  Rows past Sq or Sk are zero-filled by the
//   copy (so the masks above only make sure: a zero key row adds dS 0 to
//   dq, a zero query row P^T 0 to dv and dS^T = 0 to dk); a warp whose
//   rows all lie past the edge skips the products; no row past the edge is
//   stored.
//
// kSplit > 1 (few items: the decoders' [1, 768, 8, 64], Cut3R's dk/dv over
// its 64 state keys): the looped tiles (key tiles for dq, query tiles for
// dk/dv) split over the kSplit blocks of a cluster, block r taking tiles
// [r n / kSplit, (r + 1) n / kSplit); each keeps its partial sums in its
// shared memory, and after a cluster barrier block r adds up rows [r kRows
// / kSplit, (r + 1) kRows / kSplit) of every block's partials in rank order
// (merge_partials).  No atomics and a fixed order: two launches give the
// same bits.
// ---------------------------------------------------------------------------

constexpr int kBwdD = 64;   // the bodies' head width
constexpr int kBwdBK = 64;  // rows of a streamed tile
constexpr int kBwdTM = 4;   // a lane's rows
// the products' loops unrolled by 8 steps of 4 d, the updates' by 16 rows:
// the loop bodies stay small enough for the instruction caches
constexpr int kBwdUnrollD = 8, kBwdUnrollK = 16;

template <int kWarps, int kStages, int kSplit>
struct BwdRegShape {
  static constexpr int kRows = 4 * kBwdTM * kWarps;        // resident rows of a block
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTileFloats = kBwdBK * kBwdD;       // one streamed tile
  static constexpr int kSlotFloats = 2 * kTileFloats;      // (k, v) or (q, dO)
  static constexpr int kBufFloats = kBwdBK * 4 * kBwdTM;   // a warp's P / dS buffer
  static constexpr int kFloats = 2 * kRows * kBwdD + kStages * kSlotFloats + kWarps * kBufFloats;
  // blocks an SM holds by shared memory (228 KB an SM, 1 KB reserved a
  // block), at most 4; the launch bounds hold registers to what that many
  // need
  static constexpr int kBlocksPerSm =
      233472 / (kFloats * 4 + 1024) < 4 ? 233472 / (kFloats * 4 + 1024) : 4;
  static_assert(kBwdTM == 4, "a lane's rows of a streamed row fill one 16-byte slot");
  static_assert(kStages >= 2, "a ring of at least two slots");
  static_assert(kSplit == 1 || kSplit == 2 || kSplit == 4 || kSplit == 8, "clusters of 1-8");
  // the merge's partials ([kRows][64] for dq, two of them for dk/dv) over the ring
  static_assert(2 * kRows * kBwdD <= kStages * kSlotFloats, "merge space");
  static_assert(kRows * 16 % kThreads == 0 && kBwdBK * 16 % kThreads == 0, "whole copies");
  static_assert(kRows / kSplit * 16 % kThreads == 0, "whole merge steps");
};

// the float offset of 16-byte chunk x (x < 16) of row r of a [rows][64] tile
// whose chunks are XOR-swizzled by the row's low 3 bits
__device__ __forceinline__ int swz(int r, int x) { return r * kBwdD + 4 * (x ^ (r & 7)); }

// rows [r0, r0 + R) of one head's rows `src` (row stride ss floats) into the
// swizzled tile `dst`, 16 bytes per copy; rows at or past `lim` are
// zero-filled (r0 < lim, so row r0 is a valid address)
template <int R, int NT>
__device__ __forceinline__ void copy_tile(float* dst, const float* src, int64_t ss, int r0,
                                          int lim, int tid) {
#pragma unroll
  for (int n = 0; n < R * 16 / NT; ++n) {
    const int c = tid + n * NT, r = c / 16, x = c % 16;
    const bool ok = r0 + r < lim;
    sm90::cp_async16(dst + swz(r, x), src + (int64_t)(ok ? r0 + r : r0) * ss + 4 * x, ok);
  }
}

// The float offset in a warp's buffer (4 float4 slots a streamed row, one
// per row group) of row kk's slot of row group rg, XORed with a pattern of
// kk that spreads a quarter-warp's 8 rows (cl + 8j) over distinct banks
__device__ __forceinline__ int buf_offset(int kk, int rg) {
  return 16 * kk + 4 * (rg ^ ((kk >> 1) & 3));
}

// x[i][j] = sum_d a[row0 + 4i][d] b[cl + 8j][d]: the lane's 4 resident rows
// of `a` against 8 streamed rows of `b` (both swizzled tiles), in 16-byte
// loads along d, each sum in the order of d
__device__ __forceinline__ void tile_scores(float (&x)[kBwdTM][8], const float* a,
                                            const float* b, int row0, int cl) {
#pragma unroll
  for (int i = 0; i < kBwdTM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) x[i][j] = 0.f;
#pragma unroll (kBwdUnrollD)
  for (int c = 0; c < kBwdD / 4; ++c) {
    float4 av[kBwdTM];
#pragma unroll
    for (int i = 0; i < kBwdTM; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + swz(row0 + 4 * i, c));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(b + swz(cl + 8 * j, c));
#pragma unroll
      for (int i = 0; i < kBwdTM; ++i) {
        x[i][j] = fmaf(av[i].x, bv.x, x[i][j]);
        x[i][j] = fmaf(av[i].y, bv.y, x[i][j]);
        x[i][j] = fmaf(av[i].z, bv.z, x[i][j]);
        x[i][j] = fmaf(av[i].w, bv.w, x[i][j]);
      }
    }
  }
}

// acc[i][.] += sum_kk w[kk][i] t[kk][.]: the warp's buffer (row kk's slot of
// row group rg holds the lane's 4 rows' weights) times the streamed tile `t`
// at the lane's columns [4cl, 4cl + 4) and [32 + 4cl, 36 + 4cl), kk in order
__device__ __forceinline__ void tile_update(float (&acc)[kBwdTM][8], const float* buf,
                                            const float* t, int rg, int cl) {
  static_assert(kBwdUnrollK % 8 == 0, "the slot and chunk patterns repeat every 8 rows");
#pragma unroll (kBwdUnrollK)
  for (int kk = 0; kk < kBwdBK; ++kk) {
    const float4 w = *reinterpret_cast<const float4*>(buf + buf_offset(kk, rg));
    const float wr[kBwdTM] = {w.x, w.y, w.z, w.w};
    const float4 lo = *reinterpret_cast<const float4*>(t + swz(kk, cl));
    const float4 hi = *reinterpret_cast<const float4*>(t + swz(kk, 8 + cl));
#pragma unroll
    for (int i = 0; i < kBwdTM; ++i) {
      acc[i][0] = fmaf(wr[i], lo.x, acc[i][0]);
      acc[i][1] = fmaf(wr[i], lo.y, acc[i][1]);
      acc[i][2] = fmaf(wr[i], lo.z, acc[i][2]);
      acc[i][3] = fmaf(wr[i], lo.w, acc[i][3]);
      acc[i][4] = fmaf(wr[i], hi.x, acc[i][4]);
      acc[i][5] = fmaf(wr[i], hi.y, acc[i][5]);
      acc[i][6] = fmaf(wr[i], hi.z, acc[i][6]);
      acc[i][7] = fmaf(wr[i], hi.w, acc[i][7]);
    }
  }
}

// buffer slots of the streamed rows cl + 8j: the lane's 4 rows of x
__device__ __forceinline__ void put_slots(float* buf, const float (&x)[kBwdTM][8], int rg,
                                          int cl) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<float4*>(buf + buf_offset(cl + 8 * j, rg)) =
        make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
}

// the lane's rows first + 4i of acc into the packed rows `out` (row stride
// ss), rows at or past S not stored
__device__ __forceinline__ void store_rows_f32(float* out, int64_t ss,
                                               const float (&acc)[kBwdTM][8], int first, int S,
                                               int cl) {
#pragma unroll
  for (int i = 0; i < kBwdTM; ++i) {
    const int row = first + 4 * i;
    if (row >= S) continue;
    float* o = out + (int64_t)row * ss + 4 * cl;
    *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(o + 32) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// rows [r0, r0 + R) of the cluster's partials (each block's [rows][64] at
// the same shared offset `part`) added up in rank order into the packed rows
// `out` (row stride ss) from row `base` on, rows at or past S not stored
template <int kSplit, int R, int NT>
__device__ __forceinline__ void merge_partials(const float* part, int r0, float* out, int64_t ss,
                                               int base, int S, int tid) {
#pragma unroll
  for (int n = 0; n < R * 16 / NT; ++n) {
    const int c = tid + n * NT, r = r0 + c / 16, x = 4 * (c % 16);
    float4 y = sm90::ld_cluster_f32x4(part + r * kBwdD + x, 0);
#pragma unroll
    for (int sp = 1; sp < kSplit; ++sp) {  // rank order
      const float4 a = sm90::ld_cluster_f32x4(part + r * kBwdD + x, sp);
      y = make_float4(y.x + a.x, y.y + a.y, y.z + a.z, y.w + a.w);
    }
    if (base + r < S) *reinterpret_cast<float4*>(out + (int64_t)(base + r) * ss + x) = y;
  }
}

#define UNIGEO_BWD_REG_PARAMS                                                              \
  const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,  \
      const float* __restrict__ dout, const float* __restrict__ lse,                      \
      const float* __restrict__ delta

template <int kWarps, int kStages, int kSplit>
__global__ void __launch_bounds__(BwdRegShape<kWarps, kStages, kSplit>::kThreads,
                                  BwdRegShape<kWarps, kStages, kSplit>::kBlocksPerSm)
bwd_dq_f32reg_kernel(UNIGEO_BWD_REG_PARAMS, float* __restrict__ dq, int Sq, int Sk,
                     float scale) {
  using Shape = BwdRegShape<kWarps, kStages, kSplit>;
  constexpr int BQ = Shape::kRows, NT = Shape::kThreads, TM = kBwdTM;
  extern __shared__ __align__(16) float bwd_reg_smem[];
  float* qs = bwd_reg_smem;                           // [BQ][64], resident
  float* dos = qs + BQ * kBwdD;                       // [BQ][64], resident
  float* ring = dos + BQ * kBwdD;                     // kStages x (k, v) [64][64]
  float* bufs = ring + kStages * Shape::kSlotFloats;  // kWarps x [64][16]

  const float scale_log2 = scale * kLog2e;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, rg = lane / 8, cl = lane % 8;
  const int split = kSplit > 1 ? (int)sm90::cluster_rank() : 0;
  const int q0 = blockIdx.x / kSplit * BQ, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int64_t hd = (int64_t)H * kBwdD, bh = (int64_t)b * H + h;
  const int n_all = (Sk + kBwdBK - 1) / kBwdBK;
  const int t0 = split * n_all / kSplit, n_tiles = (split + 1) * n_all / kSplit - t0;
  const int64_t qoff = (int64_t)b * Sq * hd + (int64_t)h * kBwdD;
  const int64_t koff = (int64_t)b * Sk * hd + (int64_t)h * kBwdD;
  const auto issue = [&](int it) {  // key tile t0 + it into its slot
    float* slot = ring + it % kStages * Shape::kSlotFloats;
    const int k0 = (t0 + it) * kBwdBK;
    copy_tile<kBwdBK, NT>(slot, k + koff, hd, k0, Sk, tid);
    copy_tile<kBwdBK, NT>(slot + Shape::kTileFloats, v + koff, hd, k0, Sk, tid);
  };
  copy_tile<BQ, NT>(qs, q + qoff, hd, q0, Sq, tid);  // q and dO join tile 0's group
  copy_tile<BQ, NT>(dos, dout + qoff, hd, q0, Sq, tid);
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < n_tiles) issue(it);
    sm90::cp_async_commit();
  }

  // lse log2 e and delta scale of this lane's rows row0 + 4i (0 past Sq)
  const int row0 = warp * 4 * TM + rg;
  const bool live = q0 + warp * 4 * TM < Sq;  // the warp holds a query row
  const float* lse_bh = lse + bh * Sq;
  const float* delta_bh = delta + bh * Sq;
  float lse2[TM], dlt[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + row0 + 4 * i;
    const bool ok = row < Sq;
    lse2[i] = ok ? lse_bh[row] * kLog2e : 0.f;
    dlt[i] = ok ? delta_bh[row] * scale : 0.f;
  }
  float* buf = bufs + warp * Shape::kBufFloats;
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    sm90::cp_async_wait<kStages - 2>();  // this thread's copies of tile it
    __syncthreads();                     // everyone's; and tile it - 1 is consumed
    if (it + kStages - 1 < n_tiles) issue(it + kStages - 1);
    sm90::cp_async_commit();  // (empty past the last tile: the count stays uniform)
    if (!live) continue;
    const float* ks = ring + it % kStages * Shape::kSlotFloats;
    const float* vs = ks + Shape::kTileFloats;

    float s[TM][8], dp[TM][8];
    tile_scores(s, qs, ks, row0, cl);    // S = q k^T
    tile_scores(dp, dos, vs, row0, cl);  // dP = dO v^T
    // s <- dS = P (dP scale - delta scale); key cl + 8j of the tile is one
    // iff cl + 8j < lim, else P = 0
    const int lim = Sk - (t0 + it) * kBwdBK;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float p = exp2_approx(fmaf(s[i][j], scale_log2, -lse2[i]));
        s[i][j] = cl + 8 * j < lim ? p * fmaf(dp[i][j], scale, -dlt[i]) : 0.f;
      }
    __syncwarp();  // the warp's lanes have read the previous tile's dS
    put_slots(buf, s, rg, cl);
    __syncwarp();
    tile_update(acc, buf, ks, rg, cl);  // dq += dS k
  }

  if constexpr (kSplit == 1) {
    store_rows_f32(dq + qoff, hd, acc, q0 + row0, Sq, cl);
  } else {
    // the partial [BQ][64] over the ring (every copy has landed and been read)
    sm90::cp_async_wait<0>();
    __syncthreads();
    store_rows_f32(ring, kBwdD, acc, row0, BQ, cl);
    sm90::cluster_sync();  // every block's partials are written
    constexpr int R = BQ / kSplit;  // rows this block adds up
    merge_partials<kSplit, R, NT>(ring, split * R, dq + qoff, hd, q0, Sq, tid);
    sm90::cluster_sync();  // no block leaves while another reads its partials
  }
}

template <int kWarps, int kStages, int kSplit>
__global__ void __launch_bounds__(BwdRegShape<kWarps, kStages, kSplit>::kThreads,
                                  BwdRegShape<kWarps, kStages, kSplit>::kBlocksPerSm)
bwd_dkv_f32reg_kernel(UNIGEO_BWD_REG_PARAMS, float* __restrict__ dk, float* __restrict__ dv,
                      int Sq, int Sk, float scale) {
  using Shape = BwdRegShape<kWarps, kStages, kSplit>;
  constexpr int BK = Shape::kRows, NT = Shape::kThreads, TM = kBwdTM;
  extern __shared__ __align__(16) float bwd_reg_smem[];
  float* ks = bwd_reg_smem;                           // [BK][64], resident
  float* vs = ks + BK * kBwdD;                        // [BK][64], resident
  float* ring = vs + BK * kBwdD;                      // kStages x (q, dO) [64][64]
  float* bufs = ring + kStages * Shape::kSlotFloats;  // kWarps x [64][16]

  const float scale_log2 = scale * kLog2e;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, rg = lane / 8, cl = lane % 8;
  const int split = kSplit > 1 ? (int)sm90::cluster_rank() : 0;
  const int k0 = blockIdx.x / kSplit * BK, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int64_t hd = (int64_t)H * kBwdD, bh = (int64_t)b * H + h;
  const int n_all = (Sq + kBwdBK - 1) / kBwdBK;
  const int t0 = split * n_all / kSplit, n_tiles = (split + 1) * n_all / kSplit - t0;
  const int64_t qoff = (int64_t)b * Sq * hd + (int64_t)h * kBwdD;
  const int64_t koff = (int64_t)b * Sk * hd + (int64_t)h * kBwdD;
  const auto issue = [&](int it) {  // query tile t0 + it into its slot
    float* slot = ring + it % kStages * Shape::kSlotFloats;
    const int q0 = (t0 + it) * kBwdBK;
    copy_tile<kBwdBK, NT>(slot, q + qoff, hd, q0, Sq, tid);
    copy_tile<kBwdBK, NT>(slot + Shape::kTileFloats, dout + qoff, hd, q0, Sq, tid);
  };
  copy_tile<BK, NT>(ks, k + koff, hd, k0, Sk, tid);  // k and v join tile 0's group
  copy_tile<BK, NT>(vs, v + koff, hd, k0, Sk, tid);
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < n_tiles) issue(it);
    sm90::cp_async_commit();
  }

  const int row0 = warp * 4 * TM + rg;        // this lane's key rows: row0 + 4i
  const bool live = k0 + warp * 4 * TM < Sk;  // the warp holds a key row
  const float* lse_bh = lse + bh * Sq;
  const float* delta_bh = delta + bh * Sq;
  float* buf = bufs + warp * Shape::kBufFloats;
  float acck[TM][8], accv[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acck[i][c] = accv[i][c] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    sm90::cp_async_wait<kStages - 2>();  // this thread's copies of tile it
    __syncthreads();                     // everyone's; and tile it - 1 is consumed
    if (it + kStages - 1 < n_tiles) issue(it + kStages - 1);
    sm90::cp_async_commit();  // (empty past the last tile: the count stays uniform)
    if (!live) continue;
    const float* qs = ring + it % kStages * Shape::kSlotFloats;
    const float* dos = qs + Shape::kTileFloats;

    // lse log2 e and delta scale of this lane's queries cl + 8j, a query iff
    // cl + 8j < lim (read while S^T runs; 0 past Sq)
    const int q0 = (t0 + it) * kBwdBK, lim = Sq - q0;
    float l2[8], dl[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qi = q0 + cl + 8 * j;
      const bool ok = cl + 8 * j < lim;
      l2[j] = ok ? lse_bh[qi] * kLog2e : 0.f;
      dl[j] = ok ? delta_bh[qi] * scale : 0.f;
    }
    float x[TM][8];
    tile_scores(x, ks, qs, row0, cl);  // S^T = k q^T
    // x <- P^T, 0 for queries past Sq
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float p = exp2_approx(fmaf(x[i][j], scale_log2, -l2[j]));
        x[i][j] = cl + 8 * j < lim ? p : 0.f;
      }
    __syncwarp();  // the warp's lanes have read the previous tile's dS^T
    put_slots(buf, x, rg, cl);
    __syncwarp();
    tile_update(accv, buf, dos, rg, cl);  // dv += P^T dO
    tile_scores(x, vs, dos, row0, cl);    // dP^T = v dO^T
    // x <- dS^T = P^T (dP^T scale - delta scale), P^T from the lane's own slots
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(buf + buf_offset(cl + 8 * j, rg));
      x[0][j] = p.x * fmaf(x[0][j], scale, -dl[j]);
      x[1][j] = p.y * fmaf(x[1][j], scale, -dl[j]);
      x[2][j] = p.z * fmaf(x[2][j], scale, -dl[j]);
      x[3][j] = p.w * fmaf(x[3][j], scale, -dl[j]);
    }
    __syncwarp();  // every lane has read P^T
    put_slots(buf, x, rg, cl);
    __syncwarp();
    tile_update(acck, buf, qs, rg, cl);  // dk += dS^T q
  }

  if constexpr (kSplit == 1) {
    store_rows_f32(dk + koff, hd, acck, k0 + row0, Sk, cl);
    store_rows_f32(dv + koff, hd, accv, k0 + row0, Sk, cl);
  } else {
    // the partials [BK][64] over the ring (every copy has landed and been read)
    sm90::cp_async_wait<0>();
    __syncthreads();
    float* part_v = ring + BK * kBwdD;
    store_rows_f32(ring, kBwdD, acck, row0, BK, cl);
    store_rows_f32(part_v, kBwdD, accv, row0, BK, cl);
    sm90::cluster_sync();  // every block's partials are written
    constexpr int R = BK / kSplit;  // rows this block adds up
    merge_partials<kSplit, R, NT>(ring, split * R, dk + koff, hd, k0, Sk, tid);
    merge_partials<kSplit, R, NT>(part_v, split * R, dv + koff, hd, k0, Sk, tid);
    sm90::cluster_sync();  // no block leaves while another reads its partials
  }
}

#undef UNIGEO_BWD_REG_PARAMS

// ---------------------------------------------------------------------------
// bf16, tensor cores: TMA -> mbarrier ring -> wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kTile = 64;  // rows of a TMA box, a ring slot, a consumer warpgroup
constexpr int kStages = 4;  // ring slots
constexpr int kProducerRegs = 24;
// consumer warpgroups a block: dk/dv holds more accumulators a thread, so
// fewer of its consumers fit (Block::kConsumerRegs)
constexpr int kDkvConsumers = 2, kDqConsumers = 3;

// a warp-specialised block of one producer and C consumer warpgroups
template <int C>
struct Block {
  static_assert(C == 2 || C == 3, "the register split below is tried for 2 and 3 consumers");
  static constexpr int kThreads = 128 * (C + 1);
  static constexpr int kRows = C * kTile;       // the block's own rows
  static constexpr int kConsumerWarps = 4 * C;  // arrivals that free a slot
  // the registers the producer gives up, shared among the consumers
  static constexpr int kConsumerRegs = (65536 - 128 * kProducerRegs) / (128 * C) / 8 * 8;
};

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() { return kTile * D * sizeof(__nv_bfloat16); }

template <int D>
constexpr CUtensorMapSwizzle tma_swizzle() {
  return D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
}

// The dk/dv block's shared memory.  A slot holds dO before q: a descriptor
// that misreads dO, as the planted transpose-bit fault of
// tests/test_torch_cuda.py does, still reads inside the slot.
template <int D>
struct DkvSmem {
  struct Slot {
    __nv_bfloat16 dout[kTile * D];
    __nv_bfloat16 q[kTile * D];
  };
  __nv_bfloat16 k[kDkvConsumers * kTile * D];  // resident
  __nv_bfloat16 v[kDkvConsumers * kTile * D];
  Slot slot[kStages];
  float lse2[kStages][kTile];       // lse * log2(e) of the slot's queries
  float delta[kStages][kTile];      // delta * scale
  uint64_t full[kStages], empty[kStages], kv_full;
};

template <int D>
struct DqSmem {
  struct Slot {
    __nv_bfloat16 k[kTile * D];
    __nv_bfloat16 v[kTile * D];
  };
  __nv_bfloat16 q[kDqConsumers * kTile * D];  // resident
  __nv_bfloat16 dout[kDqConsumers * kTile * D];
  Slot slot[kStages];
  uint64_t full[kStages], empty[kStages], qdo_full;
};

// C fragments of a 64 x 64 f32 tile (columns = the summed index of the next
// product) as the bf16 A fragments of its four k-steps
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4][4], const float (&c)[32]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i][0] = pack_bf16x2(c[8 * i + 0], c[8 * i + 1]);
    a[i][1] = pack_bf16x2(c[8 * i + 2], c[8 * i + 3]);
    a[i][2] = pack_bf16x2(c[8 * i + 4], c[8 * i + 5]);
    a[i][3] = pack_bf16x2(c[8 * i + 6], c[8 * i + 7]);
  }
}

// the rows [r0, r0 + 64) of one consumer's accumulator (64 x D) into the
// packed output at row stride hd, rows past S not stored
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 2], int r0,
                                           int S, int64_t hd, int w, int g, int tg) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = r0 + 16 * w + g + 8 * i;
    if (s >= S) continue;
    __nv_bfloat16* row = out + (int64_t)s * hd + 2 * tg;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16x2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(Block<kDkvConsumers>::kThreads, 1)
bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
                     int Sk, float scale) {
  using Tile = sm90::SwizzledTile<D>;
  extern __shared__ unsigned char smem_raw[];
  using Blk = Block<kDkvConsumers>;
  DkvSmem<D>& sm = sm90::aligned_smem<DkvSmem<D>>(smem_raw);
  const int k0 = blockIdx.x * Blk::kRows, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int n_tiles = (Sq + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.full[s], 32);  // the producer warp's lanes
      sm90::mbar_init(&sm.empty[s], Blk::kConsumerWarps);
    }
    sm90::mbar_init(&sm.kv_full, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one warp loads; lane 0 issues the TMA, every lane stages
    // the slot's lse and delta and arrives on its full barrier
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const float* lse_bh = lse + ((int64_t)b * H + h) * Sq;
      const float* delta_bh = delta + ((int64_t)b * H + h) * Sq;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&sm.kv_full, 2 * kDkvConsumers * tile_bytes<D>());
        for (int r = 0; r < kDkvConsumers; ++r) {
          sm90::tma_load_3d(sm.k + r * kTile * D, &tm_k, &sm.kv_full, h * D, k0 + r * kTile, b);
          sm90::tma_load_3d(sm.v + r * kTile * D, &tm_v, &sm.kv_full, h * D, k0 + r * kTile, b);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages, q0 = it * kTile;
        sm90::mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        for (int i = lane; i < kTile; i += 32) {
          const bool valid = q0 + i < Sq;
          sm.lse2[s][i] = valid ? lse_bh[q0 + i] * kLog2e : 0.f;
          sm.delta[s][i] = valid ? delta_bh[q0 + i] * scale : 0.f;
        }
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * tile_bytes<D>());
          sm90::tma_load_3d(sm.slot[s].q, &tm_q, &sm.full[s], h * D, q0, b);
          sm90::tma_load_3d(sm.slot[s].dout, &tm_do, &sm.full[s], h * D, q0, b);
        } else {
          sm90::mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {
    // consumer c: keys [k0 + 64c, k0 + 64c + 64)
    sm90::setmaxnreg_inc<Blk::kConsumerRegs>();
    const int c = wg - 1, w = (threadIdx.x / 32) % 4, g = lane / 4, tg = lane % 4;
    const float scale_log2 = scale * kLog2e;
    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    const __nv_bfloat16* ks = sm.k + c * kTile * D;  // this consumer's k and v, A
    const __nv_bfloat16* vs = sm.v + c * kTile * D;
    sm90::mbar_wait(&sm.kv_full, 0);

    for (int it = 0; it < n_tiles; ++it) {  // query tiles
      const int s = it % kStages, q0 = it * kTile;
      const __nv_bfloat16* qs = sm.slot[s].q;
      const __nv_bfloat16* dos = sm.slot[s].dout;
      sm90::mbar_wait(&sm.full[s], (it / kStages) & 1);

      // S^T = k q^T and dP^T = v dO^T (A = k, v, B = the slot's q, dO, all
      // K-major; the first k-step overwrites, so st and dpt start undefined)
      float st[32], dpt[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int i = 0; i < D / 16; ++i)
        sm90::wgmma_ss64<0, 0>(st, Tile::kmajor(ks, i), Tile::kmajor(qs, i), i);
      sm90::wgmma_commit();
#pragma unroll
      for (int i = 0; i < D / 16; ++i)
        sm90::wgmma_ss64<0, 0>(dpt, Tile::kmajor(vs, i), Tile::kmajor(dos, i), i);
      sm90::wgmma_commit();

      // lse * log2(e) and delta * scale of this thread's queries (columns
      // 8j + 2tg and 8j + 2tg + 1), read while the products run
      float2 l2[8], dl[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        l2[j] = *reinterpret_cast<const float2*>(&sm.lse2[s][8 * j + 2 * tg]);
        dl[j] = *reinterpret_cast<const float2*>(&sm.delta[s][8 * j + 2 * tg]);
      }
      const int lim = Sq - q0 - 2 * tg;  // column 8j + 2tg + e is a query iff 8j + e < lim

      // st <- P^T, 0 for queries past Sq
      sm90::wgmma_wait<1>();
      sm90::fence_regs(st);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(st[4 * j + e] * scale_log2 - (e & 1 ? l2[j].y : l2[j].x));
          st[4 * j + e] = 8 * j + (e & 1) < lim ? p : 0.f;
        }
      // dpt <- dS^T = P^T o (dP^T - delta) * scale
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * j + e] =
              st[4 * j + e] * fmaf(dpt[4 * j + e], scale, -(e & 1 ? dl[j].y : dl[j].x));

      // dv += P^T dO,  dk += dS^T q (B = the slot's dO, q as MN-major)
      uint32_t pa[4][4], dsa[4][4];
      c_to_a(pa, st);
      c_to_a(dsa, dpt);
      sm90::fence_regs(pa);
      sm90::fence_regs(dsa);
      sm90::fence_regs(acc_v);
      sm90::fence_regs(acc_k);
      sm90::wgmma_fence();
#pragma unroll
      for (int i = 0; i < 4; ++i) sm90::wgmma_rs<D, 1>(acc_v, pa[i], Tile::mnmajor(dos, i), 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) sm90::wgmma_rs<D, 1>(acc_k, dsa[i], Tile::mnmajor(qs, i), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc_v);
      sm90::fence_regs(acc_k);
      sm90::fence_regs(pa);
      sm90::fence_regs(dsa);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&sm.empty[s]);  // the slot is free
    }

    const int64_t hd = (int64_t)H * D, off = (int64_t)b * Sk * hd + (int64_t)h * D;
    store_rows<D>(dk + off, acc_k, k0 + c * kTile, Sk, hd, w, g, tg);
    store_rows<D>(dv + off, acc_v, k0 + c * kTile, Sk, hd, w, g, tg);
  }
}

template <int D>
__global__ void __launch_bounds__(Block<kDqConsumers>::kThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, float scale) {
  using Tile = sm90::SwizzledTile<D>;
  extern __shared__ unsigned char smem_raw[];
  using Blk = Block<kDqConsumers>;
  DqSmem<D>& sm = sm90::aligned_smem<DqSmem<D>>(smem_raw);
  const int q0 = blockIdx.x * Blk::kRows, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int n_tiles = (Sk + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      sm90::mbar_init(&sm.empty[s], Blk::kConsumerWarps);
    }
    sm90::mbar_init(&sm.qdo_full, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every TMA load
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(&sm.qdo_full, 2 * kDqConsumers * tile_bytes<D>());
      for (int r = 0; r < kDqConsumers; ++r) {
        sm90::tma_load_3d(sm.q + r * kTile * D, &tm_q, &sm.qdo_full, h * D, q0 + r * kTile, b);
        sm90::tma_load_3d(sm.dout + r * kTile * D, &tm_do, &sm.qdo_full, h * D, q0 + r * kTile,
                          b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        sm90::mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * tile_bytes<D>());
        sm90::tma_load_3d(sm.slot[s].k, &tm_k, &sm.full[s], h * D, it * kTile, b);
        sm90::tma_load_3d(sm.slot[s].v, &tm_v, &sm.full[s], h * D, it * kTile, b);
      }
    }
  } else {
    // consumer c: queries [q0 + 64c, q0 + 64c + 64)
    sm90::setmaxnreg_inc<Blk::kConsumerRegs>();
    const int c = wg - 1, w = (threadIdx.x / 32) % 4, g = lane / 4, tg = lane % 4;
    const float scale_log2 = scale * kLog2e;
    float lse2[2], dlt[2];  // lse * log2(e), delta * scale of this thread's two rows
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + c * kTile + 16 * w + g + 8 * i;
      const int64_t rid = ((int64_t)b * H + h) * Sq + row;
      lse2[i] = row < Sq ? lse[rid] * kLog2e : 0.f;
      dlt[i] = row < Sq ? delta[rid] * scale : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    const __nv_bfloat16* qs = sm.q + c * kTile * D;  // this consumer's q and dO, A
    const __nv_bfloat16* dos = sm.dout + c * kTile * D;
    sm90::mbar_wait(&sm.qdo_full, 0);

    for (int it = 0; it < n_tiles; ++it) {  // key tiles
      const int sl = it % kStages, k0 = it * kTile;
      const __nv_bfloat16* ks = sm.slot[sl].k;
      const __nv_bfloat16* vs = sm.slot[sl].v;
      sm90::mbar_wait(&sm.full[sl], (it / kStages) & 1);

      // S = q k^T and dP = dO v^T (A = q, dO, B = the slot's k, v, all
      // K-major; the first k-step overwrites, so s and dp start undefined)
      float s[32], dp[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int i = 0; i < D / 16; ++i)
        sm90::wgmma_ss64<0, 0>(s, Tile::kmajor(qs, i), Tile::kmajor(ks, i), i);
      sm90::wgmma_commit();
#pragma unroll
      for (int i = 0; i < D / 16; ++i)
        sm90::wgmma_ss64<0, 0>(dp, Tile::kmajor(dos, i), Tile::kmajor(vs, i), i);
      sm90::wgmma_commit();

      // s <- P, 0 for keys past Sk (key 8j + 2tg + e is one iff 8j + e < lim)
      const int lim = Sk - k0 - 2 * tg;
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(s[4 * j + e] * scale_log2 - lse2[e >> 1]);
          s[4 * j + e] = 8 * j + (e & 1) < lim ? p : 0.f;
        }
      // s <- dS = P o (dP - delta) * scale
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= fmaf(dp[i], scale, -dlt[(i >> 1) & 1]);

      // dq += dS k (B = the slot's k as MN-major)
      uint32_t dsa[4][4];
      c_to_a(dsa, s);
      sm90::fence_regs(dsa);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int i = 0; i < 4; ++i) sm90::wgmma_rs<D, 1>(acc, dsa[i], Tile::mnmajor(ks, i), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(dsa);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&sm.empty[sl]);  // the slot is free
    }

    const int64_t hd = (int64_t)H * D;
    store_rows<D>(dq + (int64_t)b * Sq * hd + (int64_t)h * D, acc, q0 + c * kTile, Sq, hd, w, g,
                  tg);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *g0, *g1;  // dq, or dk and dv
  int B, Sq, Sk, H, D;
  float scale;
  cudaStream_t stream;
};

template <typename T, int NCOL>
cudaError_t launch_f32(const Args& a, bool dkv) {
  const int rows = dkv ? a.Sk : a.Sq;
  dim3 grid((rows + kF32Tile - 1) / kF32Tile, a.H, a.B);
  auto q = static_cast<const T*>(a.q);
  auto k = static_cast<const T*>(a.k);
  auto v = static_cast<const T*>(a.v);
  auto dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (dkv) {
    const size_t smem = f32_smem_bytes(a.D, 2);
    if ((err = set_smem(bwd_dkv_f32_kernel<T, NCOL>, smem)) != cudaSuccess) return err;
    bwd_dkv_f32_kernel<T, NCOL><<<grid, kF32Threads, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.g0), static_cast<T*>(a.g1), a.Sq,
        a.Sk, a.D, a.scale);
  } else {
    const size_t smem = f32_smem_bytes(a.D, 1);
    if ((err = set_smem(bwd_dq_f32_kernel<T, NCOL>, smem)) != cudaSuccess) return err;
    bwd_dq_f32_kernel<T, NCOL><<<grid, kF32Threads, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.g0), a.Sq, a.Sk, a.D, a.scale);
  }
  return cudaGetLastError();
}

// the CUDA-core body's two column counts by head width (any D up to 128)
template <typename T>
cudaError_t launch_cuda_core(const Args& a, bool dkv) {
  if (a.D <= 64) return launch_f32<T, 16>(a, dkv);
  if (a.D <= 128) return launch_f32<T, 32>(a, dkv);
  return cudaErrorInvalidValue;
}

// The f32 bodies at D = 64: blocks of kBwdWarps warps (16 rows each), 64-row
// tiles in a ring of kBwdStages slots; the measured choices of
// tools/backward_variants.py.
constexpr int kBwdWarps = 4, kBwdStages = 2;

// the shared memory a launch asks for, and the largest carveout, so that
// kBlocksPerSm blocks fit an SM
template <typename Kern>
cudaError_t set_f32reg_smem(Kern kern, size_t smem) {
  const cudaError_t err = set_smem(kern, smem);
  return err != cudaSuccess ? err
                            : cudaFuncSetAttribute(kern,
                                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                                   (int)cudaSharedmemCarveoutMaxShared);
}

template <int kSplit>
cudaError_t launch_f32reg(const Args& a, bool dkv) {
  using Shape = BwdRegShape<kBwdWarps, kBwdStages, kSplit>;
  constexpr size_t smem = Shape::kFloats * sizeof(float);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((dkv ? a.Sk : a.Sq) + Shape::kRows - 1) / Shape::kRows * kSplit, a.H, a.B);
  cfg.blockDim = dim3(Shape::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kSplit > 1 ? 1 : 0;
  auto q = static_cast<const float*>(a.q);
  auto k = static_cast<const float*>(a.k);
  auto v = static_cast<const float*>(a.v);
  auto dout = static_cast<const float*>(a.dout);
  cudaError_t err;
  if (dkv) {
    auto kern = bwd_dkv_f32reg_kernel<kBwdWarps, kBwdStages, kSplit>;
    if ((err = set_f32reg_smem(kern, smem)) != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, kern, q, k, v, dout, a.lse, a.delta,
                             static_cast<float*>(a.g0), static_cast<float*>(a.g1), a.Sq, a.Sk,
                             a.scale);
  } else {
    auto kern = bwd_dq_f32reg_kernel<kBwdWarps, kBwdStages, kSplit>;
    if ((err = set_f32reg_smem(kern, smem)) != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, kern, q, k, v, dout, a.lse, a.delta,
                             static_cast<float*>(a.g0), a.Sq, a.Sk, a.scale);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The split at D = 64: one block an item (kRows rows of one batch and head)
// where the items give every SM a block, or the looped side has one tile;
// else the looped tiles split over a cluster, doubled up to 8 blocks while
// SMs stay without a block and every block keeps a tile
int f32reg_split(int64_t items, int n_tiles, int sms) {
  int split = 1;
  while (split < 8 && items * split < sms && 2 * split <= n_tiles) split *= 2;
  return split;
}

cudaError_t launch_f32_d64(const Args& a, bool dkv) {
  // 16-byte copies and stores: bases aligned to 16 bytes (the row stride,
  // H * 64 * 4 bytes, is then a multiple of 16), else the launch is refused
  const uintptr_t ptrs = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                         (uintptr_t)a.dout | (uintptr_t)a.g0 |
                         (uintptr_t)(dkv ? a.g1 : a.g0);
  if (ptrs % 16) return cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  constexpr int rows = BwdRegShape<kBwdWarps, kBwdStages, 1>::kRows;
  const int64_t items = (int64_t)(((dkv ? a.Sk : a.Sq) + rows - 1) / rows) * a.H * a.B;
  const int n_tiles = ((dkv ? a.Sq : a.Sk) + kBwdBK - 1) / kBwdBK;
  switch (f32reg_split(items, n_tiles, sms)) {
    case 1: return launch_f32reg<1>(a, dkv);
    case 2: return launch_f32reg<2>(a, dkv);
    case 4: return launch_f32reg<4>(a, dkv);
    default: return launch_f32reg<8>(a, dkv);
  }
}

template <int D>
cudaError_t launch_wgmma(const Args& a, bool dkv) {
  const int hd = a.H * D;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  const struct { CUtensorMap* map; const void* ptr; int S; } maps[4] = {
      {&tq, a.q, a.Sq}, {&tk, a.k, a.Sk}, {&tv, a.v, a.Sk}, {&tdo, a.dout, a.Sq}};
  for (const auto& m : maps)
    if ((err = sm90::packed_tile_map(m.map, m.ptr, a.B, m.S, hd, D, kTile,
                                     tma_swizzle<D>())) != cudaSuccess)
      return err;
  if (dkv) {
    using Blk = Block<kDkvConsumers>;
    const dim3 grid((a.Sk + Blk::kRows - 1) / Blk::kRows, a.H, a.B);
    constexpr size_t smem = sizeof(DkvSmem<D>) + 1024;
    if ((err = set_smem(bwd_dkv_wgmma_kernel<D>, smem)) != cudaSuccess) return err;
    bwd_dkv_wgmma_kernel<D><<<grid, Blk::kThreads, smem, a.stream>>>(
        tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.g0),
        static_cast<__nv_bfloat16*>(a.g1), a.Sq, a.Sk, a.scale);
  } else {
    using Blk = Block<kDqConsumers>;
    const dim3 grid((a.Sq + Blk::kRows - 1) / Blk::kRows, a.H, a.B);
    constexpr size_t smem = sizeof(DqSmem<D>) + 1024;
    if ((err = set_smem(bwd_dq_wgmma_kernel<D>, smem)) != cudaSuccess) return err;
    bwd_dq_wgmma_kernel<D><<<grid, Blk::kThreads, smem, a.stream>>>(
        tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.g0), a.Sq, a.Sk,
        a.scale);
  }
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, int dtype, bool dkv) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.H <= 0 || a.D <= 0 || a.H > 65535 ||
      a.B > 65535 || a.g0 == nullptr || (dkv && a.g1 == nullptr))
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    // the register-tiled bodies at D = 64 (the f32 training paths), the earlier
    // body at every other width up to 128; no width is sent to another body
    if (a.D == kBwdD) return launch_f32_d64(a, dkv);
    return launch_cuda_core<float>(a, dkv);
  }
  if (dtype == 1) {
    // the wgmma bodies at D in {16, 64}: the TMA reads from 16-byte-aligned
    // bases (the row stride H*D*2 bytes is then a multiple of 16 for both
    // head widths), outputs stored as 4-byte pairs; every other width up to
    // 128, and bases the TMA cannot take, to the CUDA-core body in bf16
    const uintptr_t ptrs = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                           (uintptr_t)a.dout | (uintptr_t)a.g0 |
                           (uintptr_t)(dkv ? a.g1 : a.g0);
    if (ptrs % 16 == 0 && a.D == 16) return launch_wgmma<16>(a, dkv);
    if (ptrs % 16 == 0 && a.D == 64) return launch_wgmma<64>(a, dkv);
    return launch_cuda_core<__nv_bfloat16>(a, dkv);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dout, dq: [B, Sq, H*D]; k, v, dk, dv: [B, Sk, H*D], all contiguous;
// lse, delta: [B, H, Sq] f32 contiguous.  dtype: 0 = float32, 1 = bfloat16.
// Each returns its launch's cudaError_t (0 on success).
extern "C" int unigeo_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dq, int B, int Sq, int Sk, int H, int D, float scale,
    int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, B, Sq, Sk, H, D, scale,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch(a, dtype, false);
}

extern "C" int unigeo_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
    float scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, D, scale,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch(a, dtype, true);
}
