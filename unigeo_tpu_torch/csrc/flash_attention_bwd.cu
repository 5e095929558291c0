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
// f32 (bwd_*_f32_kernel), any D up to 128: CUDA-core FMAs, the numerics for
// f32 checks on the card.  256 threads own 64 rows, four lanes a row, each
// lane holding 16 scores of a 64-wide tile and D/4 columns of the
// accumulators; tile loads clamp their row index to the last valid row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

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

// 2^x by the SFU (ex2.approx.ftz: 2 ulp, results below 2^-126 flushed to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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
    if (a.D <= 64) return launch_f32<16>(a, dkv);
    if (a.D <= 128) return launch_f32<32>(a, dkv);
    return cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    // the TMA reads from 16-byte-aligned bases (the row stride H*D*2 bytes
    // is then a multiple of 16 for both head widths); outputs are stored as
    // 4-byte pairs
    const uintptr_t ptrs = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                           (uintptr_t)a.dout | (uintptr_t)a.g0 |
                           (uintptr_t)(dkv ? a.g1 : a.g0);
    if (ptrs % 16) return cudaErrorInvalidValue;
    if (a.D == 16) return launch_wgmma<16>(a, dkv);
    if (a.D == 64) return launch_wgmma<64>(a, dkv);
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
