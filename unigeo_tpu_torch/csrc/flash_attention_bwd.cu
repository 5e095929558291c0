// Packed flash-attention backward for Hopper (sm_90a): two kernels.
//
// Replaces: unigeo_tpu/ops/attention.py::flash_attention_tpu_bwd (Pallas
// kernels _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel), the backward of
// the differentiable packed attention (attention.py::attention_packed).
// For each batch b and head h, with head h the column slice [h*D, (h+1)*D)
// of the packed [B, S, H*D] rows of q, k, v, dO and of the outputs:
//
//   S = q k^T * scale,  P = exp(S - lse)            (lse from the forward)
//   dP = dO v^T,        dS = P o (dP - delta) * scale
//   dq = dS k,          dk = dS^T q,          dv = P^T dO
//
// delta = rowsum(dO o O) [B, H, Sq] f32 comes in from the caller, as the
// JAX package computes it outside its kernels; lse is the forward's
// [B, H, Sq] f32.  Neither kernel writes S, P or dS to device memory:
//
// * dq kernel: one block per (q tile, head, batch), looping over key tiles;
//   recomputes S and dP for its rows and accumulates dq.
// * dk/dv kernel: one block per (key tile, head, batch), looping over query
//   tiles; recomputes S^T and dP^T for its keys and accumulates dk and dv.
//
// Each kernel recomputes S and dP, so the pair does 7 products of
// Sq x Sk x D where the gradient needs 5 (S, dP, dq, dk, dv); that is this
// design's price for keeping every accumulation inside one block (no atomics,
// no second pass).
//
// What bounds it on the H100: 10*B*H*Sq*Sk*D operations (the 5 products)
// against about 2*B*D*H*(4*Sq + 4*Sk) bytes in bf16 (q, k, v, dO read, dq,
// dk, dv written; lse and delta add 8 bytes a row): at the UNet's first
// stage (Sq = Sk = 3072, d = 64) about 3800 operations a byte, far above the
// ~295 where the tensor cores become the limit, so operations bound it at
// every main-path shape.
//
// Ragged edges: every tile load clamps its row index to the last valid row,
// so no load leaves the tensor and no tile is zero-filled.  The masks alone
// keep the padded rows and columns out: the dq kernel gives keys past Sk
// P = 0 and does not store rows past Sq; the dk/dv kernel gives queries past
// Sq P = 0 and does not store keys past Sk.
//
// Two block layouts:
//
// * bf16 (bwd_*_mma_kernel), D in {16, 64} (the UNet's 64, and 16 for small
//   checks), 16-byte-aligned rows: four warps, each owning 16 rows of its
//   block's tile (queries for dq, keys for dk/dv), 64-row tiles of the other
//   side in shared memory, all five products on the tensor cores (mma.sync
//   m16n8k16, f32 accumulate).  As in the Pallas kernels, P is rounded to
//   bf16 before dv = P^T dO and dS before dq = dS k and dk = dS^T q.
// * f32 (bwd_*_f32_kernel), any D up to 128: CUDA-core FMAs, the numerics
//   for f32 checks on the card.  256 threads own 64 rows, four lanes a row,
//   each lane holding 16 scores of a 64-wide tile and D/4 columns of the
//   accumulators.
//
// This is the simple form: no TMA, no wgmma, no pipelining of tile loads
// against the products.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ int clamp_row(int s, int S) { return s < S ? s : S - 1; }

// ---------------------------------------------------------------------------
// f32, CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32Tile = 64;                          // rows of either tile
constexpr int kF32Lanes = kF32Threads / kF32Tile;     // 4 lanes per row
constexpr int kF32PerLane = kF32Tile / kF32Lanes;     // 16 scores per lane

// rows [s0, s0 + kF32Tile) of a packed head into shared memory (pitch D+1),
// row indices clamped to S-1
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int64_t ss,
                                              int s0, int S, int D, int tid) {
  const int dp = D + 1;
  for (int i = tid; i < kF32Tile * D; i += kF32Threads) {
    const int r = i / D, d = i % D;
    dst[r * dp + d] = src[(int64_t)clamp_row(s0 + r, S) * ss + d];
  }
}

size_t f32_smem_bytes(int D, int n_ptiles) {
  // four [64][D+1] tiles and n_ptiles [64][65] score tiles, plus 2 x 64 row values
  return sizeof(float) * (4 * (size_t)kF32Tile * (D + 1) +
                          (size_t)n_ptiles * kF32Tile * (kF32Tile + 1) + 2 * kF32Tile);
}

template <int NCOL>
__global__ void __launch_bounds__(kF32Threads)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, int Sq, int Sk, int D, float scale) {
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
  const float* qb = q + (int64_t)b * Sq * hd + hoff;
  const float* dob = dout + (int64_t)b * Sq * hd + hoff;
  const float* kb = k + (int64_t)b * Sk * hd + hoff;
  const float* vb = v + (int64_t)b * Sk * hd + hoff;

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
    float* out = dq + (int64_t)b * Sq * hd + (int64_t)s * hd + hoff;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int c = lane + j * kF32Lanes;
      if (c < D) out[c] = acc[j];
    }
  }
}

template <int NCOL>
__global__ void __launch_bounds__(kF32Threads)
bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv,
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
  const float* qb = q + (int64_t)b * Sq * hd + hoff;
  const float* dob = dout + (int64_t)b * Sq * hd + hoff;
  const float* kb = k + (int64_t)b * Sk * hd + hoff;
  const float* vb = v + (int64_t)b * Sk * hd + hoff;
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
        dk[off + c] = acc_k[j];
        dv[off + c] = acc_v[j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, tensor cores (mma.sync m16n8k16).  Four warps of 16 rows; tiles in
// shared memory at pitch D + 8 (the fragment loads of a warp hit 32 banks).
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaTile = kMmaWarps * 16;  // 64 rows of either tile

// rows [s0, s0 + kMmaTile) of a packed head into shared memory (pitch P),
// row indices clamped to S-1; every row is D contiguous bf16 at 16-byte-
// aligned addresses
template <int D, int P>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int64_t ss, int s0, int S, int tid) {
  constexpr int CH = D / 8;
  for (int i = tid; i < kMmaTile * CH; i += kMmaThreads) {
    const int r = i / CH, c = i % CH;
    *reinterpret_cast<uint4*>(dst + r * P + c * 8) =
        *reinterpret_cast<const uint4*>(src + (int64_t)clamp_row(s0 + r, S) * ss + c * 8);
  }
}

// the A fragment of rows [r0, r0+16), columns [kk, kk+16) of a tile at pitch P
template <int P>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int r0,
                                       int kk, int g, int tg) {
  const __nv_bfloat16* p = tile + (r0 + g) * P + kk + tg * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * P);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * P + 8);
}

// the B fragment for rows [kk, kk+16) as the k dimension and columns
// [n0, n0+8) as n, of a row-major tile at pitch P (a tile whose rows are the
// summed-over index: k in dS.k, dO in P^T.dO, q in dS^T.q)
template <int P>
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* tile, int kk, int n0,
                                            int g, int tg) {
  const unsigned short* p =
      reinterpret_cast<const unsigned short*>(tile) + (kk + tg * 2) * P + n0 + g;
  b0 = (uint32_t)p[0] | ((uint32_t)p[P] << 16);
  b1 = (uint32_t)p[8 * P] | ((uint32_t)p[9 * P] << 16);
}

// the C fragments of a 16 x 64 score block as the A fragments of its kk-th
// 16-column slice, rounded to bf16
template <int NS>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[NS][4], int kk) {
  const int j = kk / 8;
  a[0] = pack_bf16x2(c[j][0], c[j][1]);
  a[1] = pack_bf16x2(c[j][2], c[j][3]);
  a[2] = pack_bf16x2(c[j + 1][0], c[j + 1][1]);
  a[3] = pack_bf16x2(c[j + 1][2], c[j + 1][3]);
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * 4 * (size_t)kMmaTile * (D + 8) + sizeof(float) * 2 * kMmaTile;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int Sq, int Sk, float scale) {
  constexpr int P = D + 8, NO = D / 8, NS = kMmaTile / 8;
  static_assert(D % 16 == 0, "tile shapes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kMmaTile * P;
  __nv_bfloat16* ks = dos + kMmaTile * P;
  __nv_bfloat16* vs = ks + kMmaTile * P;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3, r0 = warp * 16;
  const int q0 = blockIdx.x * kMmaTile, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int64_t hd = (int64_t)H * D;
  const int64_t hoff = (int64_t)h * D;
  const float scale_log2 = scale * kLog2e;

  load_rows_bf16<D, P>(qs, q + (int64_t)b * Sq * hd + hoff, hd, q0, Sq, tid);
  load_rows_bf16<D, P>(dos, dout + (int64_t)b * Sq * hd + hoff, hd, q0, Sq, tid);
  const __nv_bfloat16* kb = k + (int64_t)b * Sk * hd + hoff;
  const __nv_bfloat16* vb = v + (int64_t)b * Sk * hd + hoff;
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t rid = ((int64_t)b * H + h) * Sq + clamp_row(q0 + r0 + g + 8 * i, Sq);
    lse2[i] = lse[rid] * kLog2e;
    dlt[i] = delta[rid];
  }

  float acc[NO][4];
#pragma unroll
  for (int t = 0; t < NO; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kMmaTile) {
    __syncthreads();
    load_rows_bf16<D, P>(ks, kb, hd, k0, Sk, tid);
    load_rows_bf16<D, P>(vs, vb, hd, k0, Sk, tid);
    __syncthreads();

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t aq[4], ado[4];
      load_a<P>(aq, qs, r0, kk, g, tg);
      load_a<P>(ado, dos, r0, kk, g, tg);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const __nv_bfloat16* kp = ks + (j * 8 + g) * P + kk + tg * 2;
        mma_16816(s[j], aq, ld32(kp), ld32(kp + 8));
        const __nv_bfloat16* vp = vs + (j * 8 + g) * P + kk + tg * 2;
        mma_16816(dp[j], ado, ld32(vp), ld32(vp + 8));
      }
    }
    // s <- dS = P o (dP - delta) * scale, P = 0 for keys past Sk
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tg * 2 + (e & 1);
        const float p = key < Sk ? exp2f(s[j][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - dlt[e >> 1]) * scale;
      }
    }
    // dq += dS . k
#pragma unroll
    for (int kk = 0; kk < kMmaTile; kk += 16) {
      uint32_t a[4];
      c_to_a(a, s, kk);
#pragma unroll
      for (int t = 0; t < NO; ++t) {
        uint32_t b0, b1;
        load_b_rows<P>(b0, b1, ks, kk, t * 8, g, tg);
        mma_16816(acc[t], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + r0 + g + 8 * i;
    if (s >= Sq) continue;
    __nv_bfloat16* out = dq + (int64_t)b * Sq * hd + (int64_t)s * hd + hoff + tg * 2;
#pragma unroll
    for (int t = 0; t < NO; ++t)
      *reinterpret_cast<uint32_t*>(out + t * 8) = pack_bf16x2(acc[t][2 * i], acc[t][2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                   int Sq, int Sk, float scale) {
  constexpr int P = D + 8, NO = D / 8, NS = kMmaTile / 8;
  static_assert(D % 16 == 0, "tile shapes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kMmaTile * P;
  __nv_bfloat16* qs = vs + kMmaTile * P;
  __nv_bfloat16* dos = qs + kMmaTile * P;
  float* lse2s = reinterpret_cast<float*>(dos + kMmaTile * P);  // [64], log2 units
  float* dlts = lse2s + kMmaTile;                                // [64]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3, r0 = warp * 16;
  const int k0 = blockIdx.x * kMmaTile, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int64_t hd = (int64_t)H * D;
  const int64_t hoff = (int64_t)h * D;
  const float scale_log2 = scale * kLog2e;

  load_rows_bf16<D, P>(ks, k + (int64_t)b * Sk * hd + hoff, hd, k0, Sk, tid);
  load_rows_bf16<D, P>(vs, v + (int64_t)b * Sk * hd + hoff, hd, k0, Sk, tid);
  const __nv_bfloat16* qb = q + (int64_t)b * Sq * hd + hoff;
  const __nv_bfloat16* dob = dout + (int64_t)b * Sq * hd + hoff;
  const float* lseb = lse + ((int64_t)b * H + h) * Sq;
  const float* deltab = delta + ((int64_t)b * H + h) * Sq;

  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int t = 0; t < NO; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[t][e] = acc_v[t][e] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += kMmaTile) {  // query tiles (tensor cores)
    __syncthreads();
    load_rows_bf16<D, P>(qs, qb, hd, q0, Sq, tid);
    load_rows_bf16<D, P>(dos, dob, hd, q0, Sq, tid);
    for (int i = tid; i < kMmaTile; i += kMmaThreads) {
      const int s = clamp_row(q0 + i, Sq);
      lse2s[i] = lseb[s] * kLog2e;
      dlts[i] = deltab[s];
    }
    __syncthreads();

    // S^T and dP^T for this warp's 16 keys against the 64 queries
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t ak[4], av[4];
      load_a<P>(ak, ks, r0, kk, g, tg);
      load_a<P>(av, vs, r0, kk, g, tg);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const __nv_bfloat16* qp = qs + (j * 8 + g) * P + kk + tg * 2;
        mma_16816(st[j], ak, ld32(qp), ld32(qp + 8));
        const __nv_bfloat16* dop = dos + (j * 8 + g) * P + kk + tg * 2;
        mma_16816(dpt[j], av, ld32(dop), ld32(dop + 8));
      }
    }
    // st <- P^T (0 for queries past Sq), dpt <- dS^T
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + tg * 2 + (e & 1);
        const float p = q0 + qc < Sq ? exp2f(st[j][e] * scale_log2 - lse2s[qc]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dlts[qc]) * scale;
      }
    }
    // dv += P^T . dO,  dk += dS^T . q
#pragma unroll
    for (int kk = 0; kk < kMmaTile; kk += 16) {
      uint32_t ap[4], ads[4];
      c_to_a(ap, st, kk);
      c_to_a(ads, dpt, kk);
#pragma unroll
      for (int t = 0; t < NO; ++t) {
        uint32_t b0, b1;
        load_b_rows<P>(b0, b1, dos, kk, t * 8, g, tg);
        mma_16816(acc_v[t], ap, b0, b1);
        load_b_rows<P>(b0, b1, qs, kk, t * 8, g, tg);
        mma_16816(acc_k[t], ads, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = k0 + r0 + g + 8 * i;
    if (s >= Sk) continue;
    const int64_t off = (int64_t)b * Sk * hd + (int64_t)s * hd + hoff + tg * 2;
#pragma unroll
    for (int t = 0; t < NO; ++t) {
      *reinterpret_cast<uint32_t*>(dk + off + t * 8) =
          pack_bf16x2(acc_k[t][2 * i], acc_k[t][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + t * 8) =
          pack_bf16x2(acc_v[t][2 * i], acc_v[t][2 * i + 1]);
    }
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

template <int NCOL>
cudaError_t launch_f32(const Args& a, bool dkv) {
  const int rows = dkv ? a.Sk : a.Sq;
  dim3 grid((rows + kF32Tile - 1) / kF32Tile, a.H, a.B);
  auto q = static_cast<const float*>(a.q);
  auto k = static_cast<const float*>(a.k);
  auto v = static_cast<const float*>(a.v);
  auto dout = static_cast<const float*>(a.dout);
  cudaError_t err;
  if (dkv) {
    const size_t smem = f32_smem_bytes(a.D, 2);
    if ((err = set_smem(bwd_dkv_f32_kernel<NCOL>, smem)) != cudaSuccess) return err;
    bwd_dkv_f32_kernel<NCOL><<<grid, kF32Threads, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.g0),
        static_cast<float*>(a.g1), a.Sq, a.Sk, a.D, a.scale);
  } else {
    const size_t smem = f32_smem_bytes(a.D, 1);
    if ((err = set_smem(bwd_dq_f32_kernel<NCOL>, smem)) != cudaSuccess) return err;
    bwd_dq_f32_kernel<NCOL><<<grid, kF32Threads, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.g0), a.Sq, a.Sk, a.D,
        a.scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const Args& a, bool dkv) {
  const int rows = dkv ? a.Sk : a.Sq;
  dim3 grid((rows + kMmaTile - 1) / kMmaTile, a.H, a.B);
  auto q = static_cast<const __nv_bfloat16*>(a.q);
  auto k = static_cast<const __nv_bfloat16*>(a.k);
  auto v = static_cast<const __nv_bfloat16*>(a.v);
  auto dout = static_cast<const __nv_bfloat16*>(a.dout);
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err;
  if (dkv) {
    if ((err = set_smem(bwd_dkv_mma_kernel<D>, smem)) != cudaSuccess) return err;
    bwd_dkv_mma_kernel<D><<<grid, kMmaThreads, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.g0),
        static_cast<__nv_bfloat16*>(a.g1), a.Sq, a.Sk, a.scale);
  } else {
    if ((err = set_smem(bwd_dq_mma_kernel<D>, smem)) != cudaSuccess) return err;
    bwd_dq_mma_kernel<D><<<grid, kMmaThreads, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.g0), a.Sq, a.Sk,
        a.scale);
  }
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, int dtype, bool dkv) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.H <= 0 || a.D <= 0 || a.H > 65535 ||
      a.B > 65535 || a.g0 == nullptr || (dkv && a.g1 == nullptr))
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (a.D <= 64) return launch_f32<16>(a, dkv);
    if (a.D <= 128) return launch_f32<32>(a, dkv);
    return cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    // 16-byte tile loads: base pointers 16-byte aligned (the row stride H*D
    // is then a multiple of 8 elements for both head widths)
    const uintptr_t ptrs = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                           (uintptr_t)a.dout | (uintptr_t)a.g0 |
                           (uintptr_t)(dkv ? a.g1 : a.g0);
    if (ptrs % 16) return cudaErrorInvalidValue;
    if (a.D == 16) return launch_mma<16>(a, dkv);
    if (a.D == 64) return launch_mma<64>(a, dkv);
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
