// Fused LayerNorm -> dense for Hopper (sm_90a), bf16 and f32.
//
// Replaces: unigeo_tpu/ops/ln_qkv.py::ln_dense_tpu (Pallas kernel
// _ln_dense_kernel).  For x [M, C], gamma, beta [C], W [N, C] (nn.Linear's
// layout, the JAX package's [C, N] Dense kernel transposed) and b [N]:
//
//   mu = mean_c x,  var = mean_c (x - mu)^2          (f32, two passes)
//   y  = round_x((x - mu) rsqrt(var + eps) gamma + beta)   (f32, rounded to x's dtype)
//   out = round_x(y W^T + b)                          (f32 accumulate, f32 bias)
//
// without writing y to device memory.  The variance is the mean of the
// centred squares, as the JAX body computes it (:35-37): E[x^2] - mu^2
// cancels for rows whose mean is large against their spread.
//
// What bounds it on the H100: 2 M C N operations against 2 (M C + N C + M N)
// bytes of bf16 (x, W, out; gamma, beta and b are negligible).  At the UNet's
// temporal-attention shapes (N = 3C) that is about 2 C N / (2 (C + 3C)) =
// 3C/4 operations per byte, 240 at C = 320 (below the ~295 at which the
// tensor cores, 989 TF/s bf16, and not memory, 3.35 TB/s, are the limit:
// bytes bound it) and 480 / 960 at C = 640 / 1280 (operations bound them).
//
// What this design does about it: the normalized rows never leave the
// block, and each row block is normalized once per item.
//
// * bf16 with 16-byte rows (C % 8 == 0, x, gamma, beta, W 16-byte aligned)
//   and C <= 1472: ln_dense_bf16_wgmma_kernel, Hopper's TMA and wgmma.  At
//   most one block per SM walks over items: 64 rows x a range of N tiles of
//   320 columns.  A block is a producer warpgroup (setmaxnreg 40) and two
//   consumer warpgroups (232 registers).  Per item the consumers compute
//   the 64 rows' f32 statistics (one warp per row at a time, two passes of
//   16-byte loads) and write y = round((x - mu) rs gamma + beta) once into
//   shared memory as ceil(C / 64) K-major boxes of 64 columns in the
//   128-byte swizzle (zeros past C and for rows past M; 160 KB at
//   C = 1280), then a proxy fence and a named barrier.  The producer thread
//   streams W through a ring of [320 rows x 32 columns] chunks (64-byte
//   swizzle, two 160-row TMA boxes; rows past N and columns past C come as
//   zeros); consumer c runs acc += y W[c 160 .. c 160 + 160)^T as m64n160
//   wgmma with both operands from shared memory, then adds the f32 bias,
//   rounds and stores its 64 x 160 outputs.  Where row blocks alone would
//   not fill the SMs (stage 2 has 75), an item takes a range of the N
//   tiles: the split count that leaves the fewest tiles, plus a third of
//   one for each item's normalization, on the busiest SM.
// * bf16 otherwise (C % 8 != 0, such as 100; unaligned pointers; wider C):
//   ln_dense_bf16_mma_kernel, the simple form.  Block = 64 rows x one N
//   tile of 128; a prologue computes the block's row statistics, then a
//   loop over C stages each K tile of x to shared memory already normalized
//   beside the matching W tile and multiplies with mma.sync m16n8k16 (bf16
//   in, f32 accumulate), 8 warps as 4 row groups of 16 x 2 column halves of
//   64, tiles padded by 8 elements per row so a warp's fragment loads hit
//   32 distinct banks.  Every N tile of a row block recomputes the
//   statistics and the normalization.  Chosen by shape and alignment in
//   unigeo_ln_dense, never as a fallback of a failed launch.
// * f32: the CUDA cores (the JAX kernel takes f32 too; no model uses it):
//   64 x 64 outputs per block, 4 x 4 per thread, K tiles of 32, f32 FMAs in
//   k order, the mma body's staging of normalized K tiles.
//
// Any M, C and N: rows past M are neither normalized (zeros) nor stored,
// columns past N load as zero weights and are not stored (the last tile of
// 320 or 128 is ragged where N is not a multiple), and the K tail past C
// loads as zeros in both operands; the statistics divide by the true C.
//
// Inputs: contiguous, all of one dtype.  16-byte vector loads where C and
// the pointers allow (bf16: C % 8 == 0, f32: C % 4 == 0, 16-byte aligned
// x, gamma, beta, W), element loads otherwise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <array>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

constexpr int kBM = 64;        // rows per block (both dtypes)
constexpr int kThreads = 256;  // 8 warps
constexpr int kBN16 = 128;     // bf16: output columns per block
constexpr int kBK16 = 64;      // bf16: slice of C per step
constexpr int kP16 = kBK16 + 8;
constexpr int kBN32 = 64;      // f32: output columns per block
constexpr int kBK32 = 32;      // f32: slice of C per step
constexpr int kP32 = kBK32 + 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// v[0..8) = p[0..valid) in f32, zeros after; one 16-byte load when vec and
// all eight are valid
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int valid, bool vec,
                                      float (&v)[8]) {
  if (vec && valid >= 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < valid ? __bfloat162float(p[j]) : 0.f;
  }
}

__device__ __forceinline__ void load8(const float* p, int valid, bool vec, float (&v)[8]) {
  if (vec && valid >= 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < valid ? p[j] : 0.f;
  }
}

// mean and 1 / sqrt(var + eps) of rows [m0, m0 + kBM) into mu, rs (zeros for
// rows past M); one warp per row at a time, two passes
template <typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ x, int M, int C, int m0,
                                          float eps, float* mu, float* rs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int row = m0 + r;
    float mean = 0.f, rstd = 0.f;
    if (row < M) {
      const T* xr = x + (int64_t)row * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
      mean = warp_sum(s) / (float)C;
      s = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = to_f32(xr[c]) - mean;
        s += d * d;
      }
      rstd = rsqrtf(warp_sum(s) / (float)C + eps);
    }
    if (lane == 0) {
      mu[r] = mean;
      rs[r] = rstd;
    }
  }
}

// eight normalized values of one row at columns [k, k + 8): valid of them
// in range, zeros after (and for rows past M, valid = 0)
template <typename T>
__device__ __forceinline__ void normalized8(const T* __restrict__ xrow, const T* __restrict__ gamma,
                                            const T* __restrict__ beta, int k, int valid, bool vec,
                                            float mean, float rstd, float (&y)[8]) {
  float xv[8], gv[8], bv[8];
  load8(xrow + k, valid, vec, xv);
  load8(gamma + k, valid, vec, gv);
  load8(beta + k, valid, vec, bv);
#pragma unroll
  for (int j = 0; j < 8; ++j) y[j] = j < valid ? (xv[j] - mean) * rstd * gv[j] + bv[j] : 0.f;
}

__global__ void __launch_bounds__(kThreads) ln_dense_bf16_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gamma,
    const __nv_bfloat16* __restrict__ beta, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M, int C, int N,
    float eps, bool vec, bool pair_store) {
  __shared__ __align__(16) __nv_bfloat16 ys[kBM * kP16];    // normalized x tile
  __shared__ __align__(16) __nv_bfloat16 ws[kBN16 * kP16];  // W tile, rows = output columns
  __shared__ float mu[kBM], rs[kBM];

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN16;
  row_stats(x, M, C, m0, eps, mu, rs);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp >> 1, wc = warp & 1;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = wr * 16;

  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kBK16) {
    __syncthreads();  // the statistics are in; every warp is done with the last tiles
    for (int i = threadIdx.x; i < kBM * (kBK16 / 8); i += kThreads) {
      const int r = i / (kBK16 / 8), c = (i % (kBK16 / 8)) * 8;
      const int row = m0 + r, k = k0 + c;
      const int valid = row < M ? min(8, C - k) : 0;
      float y[8];
      if (valid > 0) {
        normalized8(x + (int64_t)row * C, gamma, beta, k, valid, vec, mu[r], rs[r], y);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) y[j] = 0.f;
      }
      *reinterpret_cast<uint4*>(ys + r * kP16 + c) =
          make_uint4(pack_bf16x2(y[0], y[1]), pack_bf16x2(y[2], y[3]),
                     pack_bf16x2(y[4], y[5]), pack_bf16x2(y[6], y[7]));
    }
    for (int i = threadIdx.x; i < kBN16 * (kBK16 / 8); i += kThreads) {
      const int r = i / (kBK16 / 8), c = (i % (kBK16 / 8)) * 8;
      const int n = n0 + r, k = k0 + c;
      const int valid = n < N ? min(8, C - k) : 0;
      const __nv_bfloat16* src = w + (int64_t)n * C + k;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (vec && valid >= 8) {
        raw = *reinterpret_cast<const uint4*>(src);
      } else if (valid > 0) {
        alignas(16) __nv_bfloat16 tmp[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) tmp[j] = j < valid ? src[j] : __float2bfloat16(0.f);
        raw = *reinterpret_cast<const uint4*>(tmp);
      }
      *reinterpret_cast<uint4*>(ws + r * kP16 + c) = raw;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK16; kk += 16) {
      uint32_t a[4];
      const __nv_bfloat16* ap = ys + (r0 + g) * kP16 + kk + tg * 2;
      a[0] = ld32(ap);
      a[1] = ld32(ap + 8 * kP16);
      a[2] = ld32(ap + 8);
      a[3] = ld32(ap + 8 * kP16 + 8);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const __nv_bfloat16* wp = ws + (wc * 64 + t * 8 + g) * kP16 + kk + tg * 2;
        mma_16816(acc[t], a, ld32(wp), ld32(wp + 8));
      }
    }
  }

  // epilogue: + f32 bias, rounded to bf16; rows past M and columns past N
  // are not stored
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int col = n0 + wc * 64 + t * 8 + tg * 2;
    const float b0 = col < N ? __bfloat162float(bias[col]) : 0.f;
    const float b1 = col + 1 < N ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + r0 + g + 8 * i;
      if (row >= M) continue;  // rows past M are not stored
      __nv_bfloat16* o = out + (int64_t)row * N + col;
      const float v0 = acc[t][2 * i] + b0, v1 = acc[t][2 * i + 1] + b1;
      if (pair_store && col + 1 < N) {
        *reinterpret_cast<uint32_t*>(o) = pack_bf16x2(v0, v1);
      } else {
        if (col < N) o[0] = __float2bfloat16(v0);
        if (col + 1 < N) o[1] = __float2bfloat16(v1);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) ln_dense_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ w, const float* __restrict__ bias, float* __restrict__ out, int M,
    int C, int N, float eps, bool vec) {
  __shared__ float ys[kBM * kP32];    // normalized x tile
  __shared__ float ws[kBN32 * kP32];  // W tile, rows = output columns
  __shared__ float mu[kBM], rs[kBM];

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN32;
  row_stats(x, M, C, m0, eps, mu, rs);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kBK32) {
    __syncthreads();
    {  // one chunk of 8 of x and of W per thread: 64 rows x 4 chunks each
      const int r = threadIdx.x / 4, c = (threadIdx.x % 4) * 8;
      const int row = m0 + r, n = n0 + r, k = k0 + c;
      const int valid_x = row < M ? min(8, C - k) : 0;
      const int valid_w = n < N ? min(8, C - k) : 0;
      float y[8], wv[8];
      if (valid_x > 0) {
        normalized8(x + (int64_t)row * C, gamma, beta, k, valid_x, vec, mu[r], rs[r], y);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) y[j] = 0.f;
      }
      load8(w + (int64_t)n * C + k, max(valid_w, 0), vec, wv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ys[r * kP32 + c + j] = y[j];
        ws[r * kP32 + c + j] = wv[j];
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK32; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ys[(ty + 16 * i) * kP32 + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[(tx + 16 * j) * kP32 + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (row < M && col < N) out[(int64_t)row * N + col] = acc[i][j] + bias[col];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 with 16-byte rows: TMA -> mbarrier rings -> wgmma, warp-specialised.
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;      // a producer warpgroup and two consumers
constexpr int kWgBN = 320;           // output columns of an N tile
constexpr int kWgHalf = kWgBN / 2;   // a consumer's: one m64n160 product
constexpr int kWgKC = 32;            // columns of C in a W chunk (64-byte swizzle)
constexpr int kWgChunk = kWgBN * kWgKC * 2;
constexpr int kWgYBox = kBM * 64 * 2;  // 64 rows x 64 columns of x, then of y
constexpr int kWgStages = 8;
// setmaxnreg: the producer gives up what the consumers take, (168 - 40) x 128
// = (232 - 168) x 256 registers of the 168 a thread the launch holds
constexpr int kWgProducerRegs = 40, kWgConsumerRegs = 232;
constexpr int kPlanInts = 6;

using Tile128 = sm90::SwizzledTile<64>;  // y: 128-byte rows
using Tile64 = sm90::SwizzledTile<32>;   // W chunks: 64-byte rows

struct WgBars {
  uint64_t full[kWgStages], empty[kWgStages], y_full[2], y_empty[2];
};

// Byte offsets of the dynamic shared memory from a 1024-byte boundary: ny
// buffers of ceil(C / 64) boxes of x (normalized in place into y), the W
// ring of ns chunks, the mbarriers
struct WgLayout {
  int y_bytes, ring, bars, total;
  __host__ __device__ WgLayout(int C, int ny, int ns) {
    y_bytes = (C + 63) / 64 * kWgYBox;
    ring = ny * y_bytes;
    bars = ring + ns * kWgChunk;
    total = bars + (int)sizeof(WgBars);
  }
};

// The launch's shape: y buffers, W ring slots, N splits, items, blocks
struct WgPlan {
  int ny, ns, nsplit, items, blocks, tiles, smem;
};

__global__ void __launch_bounds__(kWgThreads, 1) ln_dense_bf16_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
    const __nv_bfloat16* __restrict__ gamma, const __nv_bfloat16* __restrict__ beta,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M, int C, int N,
    float eps, int ny, int ns, int nsplit, bool pair_store) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = &sm90::aligned_smem<unsigned char>(smem_raw);
  const WgLayout lay(C, ny, ns);
  WgBars& bars = *reinterpret_cast<WgBars*>(base + lay.bars);
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int n_tiles = (N + kWgBN - 1) / kWgBN, n_kc = (C + kWgKC - 1) / kWgKC;
  const int n_yb = (C + 63) / 64;
  // item -> (row block, N split), splits fastest
  const int n_items = (M + kBM - 1) / kBM * nsplit;
  const auto chunk = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(base + lay.ring + s * kWgChunk);
  };
  const auto ybuf = [&](int b) { return base + b * lay.y_bytes; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      sm90::mbar_init(&bars.full[s], 1);
      sm90::mbar_init(&bars.empty[s], 8);  // one arrival per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      sm90::mbar_init(&bars.y_full[b], 1);
      sm90::mbar_init(&bars.y_empty[b], 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: per item, the 64 rows of x into a y buffer, then the item's
    // W chunks, one TMA thread
    sm90::setmaxnreg_dec<kWgProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::Ring ring, yr;
      for (int it = blockIdx.x; it < n_items; it += gridDim.x, yr.next(ny)) {
        const int m0 = it / nsplit * kBM, sp = it % nsplit;
        sm90::mbar_wait(&bars.y_empty[yr.slot], yr.phase ^ 1);
        sm90::mbar_arrive_expect_tx(&bars.y_full[yr.slot], lay.y_bytes);
        for (int b = 0; b < n_yb; ++b)
          sm90::tma_load_3d(ybuf(yr.slot) + b * kWgYBox, &tm_x, &bars.y_full[yr.slot], 64 * b,
                            m0, 0);
        for (int t = sp * n_tiles / nsplit; t < (sp + 1) * n_tiles / nsplit; ++t)
          for (int kc = 0; kc < n_kc; ++kc, ring.next(ns)) {
            sm90::mbar_wait(&bars.empty[ring.slot], ring.phase ^ 1);
            sm90::mbar_arrive_expect_tx(&bars.full[ring.slot], kWgChunk);
            for (int c = 0; c < 2; ++c)
              sm90::tma_load_3d(chunk(ring.slot) + c * kWgHalf * kWgKC, &tm_w,
                                &bars.full[ring.slot], kWgKC * kc, t * kWgBN + c * kWgHalf, 0);
          }
      }
    }
    return;
  }

  // consumer c: output columns [c 160, c 160 + 160) of each N tile
  sm90::setmaxnreg_inc<kWgConsumerRegs>();
  const int c = wg - 1, cwarp = (threadIdx.x - 128) / 32, w = cwarp % 4, g = lane / 4,
            tg = lane % 4;
  const auto arrive = [&](uint64_t* bar) {  // one arrival per warp
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(bar);
  };
  sm90::Ring ring, ring_free, yr;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x, yr.next(ny)) {
    const int m0 = it / nsplit * kBM, sp = it % nsplit;
    unsigned char* ys = ybuf(yr.slot);
    sm90::mbar_wait(&bars.y_full[yr.slot], yr.phase);

    // y = round((x - mu) rs gamma + beta) in place, a warp per row at a time;
    // 16-byte chunk q of row r sits at box q / 8, swizzled by r % 8
    const auto at = [&](int r, int q) {
      return reinterpret_cast<uint4*>(ys + q / 8 * kWgYBox + r * 128 + (((q % 8) ^ (r & 7)) << 4));
    };
    const auto unpack = [](uint4 raw, float (&v)[8]) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        v[2 * j] = f.x;
        v[2 * j + 1] = f.y;
      }
    };
    // (mean, 1 / sqrt(var + eps)) of row r, two passes over its C columns
    const auto row_stats = [&](int r) {
      float s = 0.f;
      for (int q = lane; q < C / 8; q += 32) {
        float v[8];
        unpack(*at(r, q), v);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += v[j];
      }
      const float mean = warp_sum(s) / (float)C;
      s = 0.f;
      for (int q = lane; q < C / 8; q += 32) {
        float v[8];
        unpack(*at(r, q), v);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += (v[j] - mean) * (v[j] - mean);
      }
      return make_float2(mean, rsqrtf(warp_sum(s) / (float)C + eps));
    };
    for (int r = cwarp; r < kBM; r += 8) {
      const bool valid = m0 + r < M;
      const float2 st = row_stats(r);
      __syncwarp();  // every lane has read row r before it is overwritten
      for (int q = lane; q < n_yb * 8; q += 32) {
        float y[8];
        if (valid && q < C / 8) {
          float v[8], gv[8], bv[8];
          unpack(*at(r, q), v);
          load8(gamma + 8 * q, 8, true, gv);
          load8(beta + 8 * q, 8, true, bv);
#pragma unroll
          for (int j = 0; j < 8; ++j) y[j] = (v[j] - st.x) * st.y * gv[j] + bv[j];
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) y[j] = 0.f;
        }
        *at(r, q) = make_uint4(pack_bf16x2(y[0], y[1]), pack_bf16x2(y[2], y[3]),
                               pack_bf16x2(y[4], y[5]), pack_bf16x2(y[6], y[7]));
      }
    }
    sm90::fence_proxy_async();
    sm90::bar_sync<256>(1);  // every row of y is in

    const int t1 = (sp + 1) * n_tiles / nsplit;
    for (int t = sp * n_tiles / nsplit; t < t1; ++t) {
      float acc[kWgHalf / 2];
      for (int kc = 0; kc < n_kc; ++kc, ring.next(ns)) {
        sm90::mbar_wait(&bars.full[ring.slot], ring.phase);
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
        const __nv_bfloat16* yb = reinterpret_cast<const __nv_bfloat16*>(ys + kc / 2 * kWgYBox);
        const __nv_bfloat16* wc = chunk(ring.slot) + c * kWgHalf * kWgKC;
#pragma unroll
        for (int i = 0; i < kWgKC / 16; ++i)
          sm90::wgmma_ss<kWgHalf>(acc, Tile128::kmajor(yb, (kc & 1) * 2 + i),
                                  Tile64::kmajor(wc, i), kc > 0 || i > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        if (kc > 0) {
          arrive(&bars.empty[ring_free.slot]);
          ring_free.next(ns);
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      arrive(&bars.empty[ring_free.slot]);
      ring_free.next(ns);

      // + f32 bias, rounded to bf16; rows past M and columns past N are not
      // stored
#pragma unroll
      for (int jj = 0; jj < kWgHalf / 8; ++jj) {
        const int col = t * kWgBN + c * kWgHalf + 8 * jj + 2 * tg;
        const float b0 = col < N ? __bfloat162float(bias[col]) : 0.f;
        const float b1 = col + 1 < N ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = m0 + 16 * w + g + 8 * i;
          if (row >= M) continue;  // rows past M are not stored
          __nv_bfloat16* o = out + (int64_t)row * N + col;
          const float v0 = acc[4 * jj + 2 * i] + b0, v1 = acc[4 * jj + 2 * i + 1] + b1;
          if (pair_store && col + 1 < N) {
            *reinterpret_cast<uint32_t*>(o) = pack_bf16x2(v0, v1);
          } else {
            if (col < N) o[0] = __float2bfloat16(v0);
            if (col + 1 < N) o[1] = __float2bfloat16(v1);
          }
        }
      }
    }
    arrive(&bars.y_empty[yr.slot]);  // every product that read y is done
  }
}

// blocks of the wgmma kernel device `dev` holds at once with `smem` bytes a
// block; the kernel may take up to `smem_max` (the device's most), so that
// every plan kept for it launches
cudaError_t block_slots(int dev, int smem, int smem_max, int* slots) {
  int sms, per_sm;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ln_dense_bf16_wgmma_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ln_dense_bf16_wgmma_kernel,
                                                           kWgThreads, smem)) != cudaSuccess)
    return err;
  *slots = sms * per_sm;
  return *slots < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// The wgmma body's plan at (M, C, N) on device `dev`, or
// cudaErrorNotSupported where its y buffer does not fit (C > 1472).  Two y
// buffers (the next item's x arrives under this item's products) where a
// ring of three W chunks still fits beside them, else one; the ring as deep
// as the rest leaves room for.  N is split over items where that evens out
// the blocks' work: the split count with the fewest tiles on the busiest
// block, each item's normalization counted as a third of a tile.
cudaError_t make_wg_plan(int dev, int M, int C, int N, WgPlan* p) {
  int smem_max;
  cudaError_t err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int budget = smem_max - 1024;  // the launch asks 1024 more for the alignment
  p->ns = 0;
  for (int ny = 2; ny >= 1 && p->ns == 0; --ny) {
    const int ns = (budget - WgLayout(C, ny, 0).total) / kWgChunk;
    if (ns >= (ny == 2 ? 3 : 2)) {
      p->ny = ny;
      p->ns = ns < kWgStages ? ns : kWgStages;
    }
  }
  if (p->ns == 0) return cudaErrorNotSupported;
  p->smem = WgLayout(C, p->ny, p->ns).total + 1024;
  int slots;  // blocks the card holds at once: the walk's blocks
  if ((err = block_slots(dev, p->smem, smem_max, &slots)) != cudaSuccess) return err;
  p->tiles = (N + kWgBN - 1) / kWgBN;
  const int64_t rb = (M + kBM - 1) / kBM;
  int64_t best = INT64_MAX;
  for (int s = 1; s <= p->tiles; ++s) {
    const int64_t cost = (rb * s + slots - 1) / slots * (3 * ((p->tiles + s - 1) / s) + 1);
    if (cost < best) best = cost, p->nsplit = s;
  }
  const int64_t items = rb * p->nsplit;
  if (items > INT32_MAX) return cudaErrorInvalidValue;
  p->items = (int)items;
  p->blocks = items < slots ? (int)items : slots;
  return cudaSuccess;
}

cudaError_t launch_wgmma(const WgPlan& p, const void* x, const void* gamma, const void* beta,
                         const void* w, const void* bias, void* out, int M, int C, int N,
                         float eps, bool pair_store, cudaStream_t stream) {
  CUtensorMap tx, tw;
  cudaError_t err;
  if ((err = sm90::packed_tile_map(&tx, x, 1, M, C, 64, kBM, CU_TENSOR_MAP_SWIZZLE_128B)) !=
          cudaSuccess ||
      (err = sm90::packed_tile_map(&tw, w, 1, N, C, kWgKC, kWgHalf,
                                   CU_TENSOR_MAP_SWIZZLE_64B)) != cudaSuccess)
    return err;
  ln_dense_bf16_wgmma_kernel<<<p.blocks, kWgThreads, p.smem, stream>>>(
      tx, tw, static_cast<const __nv_bfloat16*>(gamma), static_cast<const __nv_bfloat16*>(beta),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), M, C, N, eps,
      p.ny, p.ns, p.nsplit, pair_store);
  return cudaGetLastError();
}

// the bf16 body a launch takes, by shape and alignment: cudaSuccess for
// the wgmma body (16-byte rows whose y fits; plan filled in, worked out once
// per device and sizes), cudaErrorNotSupported for the mma.sync body, any
// other error as it came
cudaError_t wgmma_plan(const void* x, const void* gamma, const void* beta, const void* w,
                       int M, int C, int N, WgPlan* p) {
  static sm90::PlanCache<std::array<int, 4>, WgPlan> cache;
  const uintptr_t ins = (uintptr_t)x | (uintptr_t)gamma | (uintptr_t)beta | (uintptr_t)w;
  if (ins % 16 || C % 8) return cudaErrorNotSupported;
  int dev;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cache.get({dev, M, C, N}, p, [&](WgPlan* q) { return make_wg_plan(dev, M, C, N, q); });
}

}  // namespace

// The bf16 body a launch at these sizes and pointers takes, and its plan:
// plan[0..6) = body (1 wgmma, 0 mma.sync), y buffers, W ring slots, N
// splits, items, blocks (the wgmma body's; zeros for the mma.sync body).
// Returns a cudaError_t.
extern "C" int unigeo_ln_dense_plan(const void* x, const void* gamma, const void* beta,
                                    const void* w, int M, int C, int N, int* plan) {
  if (M <= 0 || C <= 0 || N <= 0 || plan == nullptr) return (int)cudaErrorInvalidValue;
  WgPlan p{};
  const cudaError_t err = wgmma_plan(x, gamma, beta, w, M, C, N, &p);
  if (err != cudaSuccess && err != cudaErrorNotSupported) return (int)err;
  const bool wgmma = err == cudaSuccess;
  const int v[kPlanInts] = {wgmma, p.ny, p.ns, p.nsplit, p.items, p.blocks};
  for (int i = 0; i < kPlanInts; ++i) plan[i] = wgmma || i == 0 ? v[i] : 0;
  return 0;
}

// x [M, C], gamma, beta [C], w [N, C], bias [N], out [M, N]: contiguous, all
// bf16 (is_bf16 = 1) or all f32 (0).  Returns the launch's cudaError_t (0 on
// success); cudaErrorInvalidValue for sizes or pointers it does not take.
extern "C" int unigeo_ln_dense(const void* x, const void* gamma, const void* beta, const void* w,
                               const void* bias, void* out, int M, int C, int N, float eps,
                               int is_bf16, void* stream) {
  const int es = is_bf16 ? 2 : 4;
  const uintptr_t ins = (uintptr_t)x | (uintptr_t)gamma | (uintptr_t)beta | (uintptr_t)w;
  if (M <= 0 || C <= 0 || N <= 0 || ((ins | (uintptr_t)bias | (uintptr_t)out) % es))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const bool pair_store = N % 2 == 0 && (uintptr_t)out % 4 == 0;
    WgPlan p;
    const cudaError_t err = wgmma_plan(x, gamma, beta, w, M, C, N, &p);
    if (err == cudaSuccess)
      return (int)launch_wgmma(p, x, gamma, beta, w, bias, out, M, C, N, eps, pair_store, st);
    if (err != cudaErrorNotSupported) return (int)err;
    if ((N + kBN16 - 1) / kBN16 > 65535) return (int)cudaErrorInvalidValue;
    const bool vec = ins % 16 == 0 && C % 8 == 0;
    dim3 grid((M + kBM - 1) / kBM, (N + kBN16 - 1) / kBN16);
    ln_dense_bf16_mma_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gamma),
        static_cast<const __nv_bfloat16*>(beta), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), M, C, N, eps,
        vec, pair_store);
  } else {
    if ((N + kBN32 - 1) / kBN32 > 65535) return (int)cudaErrorInvalidValue;
    const bool vec = ins % 16 == 0 && C % 4 == 0;
    dim3 grid((M + kBM - 1) / kBM, (N + kBN32 - 1) / kBN32);
    ln_dense_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), M, C, N, eps, vec);
  }
  return (int)cudaGetLastError();
}
