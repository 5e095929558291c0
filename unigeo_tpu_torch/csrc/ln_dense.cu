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
// block.  Block = 64 rows x one N tile; a prologue computes the block's row
// statistics (one warp per row at a time, two passes over the row), then a
// loop over C stages each K tile of x to shared memory already normalized
// (gamma and beta applied in f32, rounded to the working dtype) beside the
// matching W tile, and multiplies.  The whole normalized row does not fit
// in shared memory at the widths that matter (64 x 1280 bf16 is 160 KB),
// so each K tile is normalized as it is staged and nothing is cached
// across N tiles: every N tile of a row block recomputes the statistics and
// the normalization (x is read three times per N tile, mostly from L2).
//
// * bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate) on the tensor cores;
//   64 x 128 outputs per block of 8 warps (4 row groups of 16 x 2 column
//   halves of 64), K tiles of 64, tiles padded by 8 elements per row so a
//   warp's fragment loads hit 32 distinct banks.
// * f32: the CUDA cores (the JAX kernel takes f32 too): 64 x 64 outputs per
//   block, 4 x 4 per thread, K tiles of 32, f32 FMAs in k order.
//
// Any M, C and N: rows past M are neither normalized (zeros) nor stored,
// columns past N load as zero weights and are not stored (N = 960 is 7.5
// tiles of 128), and the K tail past C loads as zeros in both operands; the
// statistics divide by the true C.  No cp.async, TMA or wgmma, and no
// double buffering: this is the simple form.
//
// Inputs: contiguous, all of one dtype.  16-byte vector loads where C and
// the pointers allow (bf16: C % 8 == 0, f32: C % 4 == 0, 16-byte aligned
// x, gamma, beta, W), element loads otherwise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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

__global__ void __launch_bounds__(kThreads) ln_dense_bf16_kernel(
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

}  // namespace

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
    if ((N + kBN16 - 1) / kBN16 > 65535) return (int)cudaErrorInvalidValue;
    const bool vec = ins % 16 == 0 && C % 8 == 0;
    const bool pair_store = N % 2 == 0 && (uintptr_t)out % 4 == 0;
    dim3 grid((M + kBM - 1) / kBM, (N + kBN16 - 1) / kBN16);
    ln_dense_bf16_kernel<<<grid, kThreads, 0, st>>>(
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
