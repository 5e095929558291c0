// Fused GEGLU feed-forward for Hopper (sm_90a), bf16.
//
// Replaces: unigeo_tpu/ops/geglu.py::geglu_ffn_tpu (Pallas kernel
// _geglu_kernel).  For x [M, C] it computes, without writing the hidden
// tensor to device memory,
//
//   v = x W1v^T + b1v,  g = x W1g^T + b1g      (f32 accumulate, f32 bias)
//   h = bf16(v * gelu_tanh(g))                  (gelu in f32, h rounded once)
//   out = bf16(sum over hidden tiles of h W2^T) (f32 accumulate, no b2)
//
// in the port's own weight layout, with no transpose copy: W1 is
// net.0.proj.weight [2H, C] (rows [0, H) the value, [H, 2H) the gate, the
// JAX package's w1[:, :H] and w1[:, H:]), b1 its bias [2H], W2 is
// net.2.weight [C_out, H].  An nn.Linear weight [out, in] is exactly the
// column-major B operand of mma.sync.m16n8k16.row.col for x W^T, so tiles
// of W1 and W2 are copied to shared memory row by row as they lie.
//
// What bounds it on the H100: 24 M C^2 operations (C_out = C, H = 4C)
// against 2 (M C + 8 C^2 + M C) bytes of bf16 (x, W1, W2 and out; b1 is
// negligible): about 3000 operations per byte at the UNet's first stage
// (M = 76800, C = 320), ten times the ~295 at which the tensor cores
// (989 TF/s bf16) and not memory (3.35 TB/s) are the limit.  The bound is
// the operations at every main-path shape.
//
// What this design does about it: both products run on the bf16 tensor
// cores (mma.sync m16n8k16, f32 accumulate), and the [M, 4C] hidden never
// leaves the block: each 64 x 64 hidden tile is produced in registers,
// gated, rounded to bf16 into shared memory and consumed by the
// down-projection at once.  The JAX kernel keeps a [256, C_out] f32
// accumulator in VMEM; on an SM a [64, 1280] f32 accumulator alone would
// be 320 KB, more than the register file (256 KB) or the shared memory a
// block may take (227 KB).  So the output columns are split over blocks
// (BN <= 320 columns each, 80 accumulator registers per thread), and every
// block recomputes the up-projection of its 64 rows over the whole hidden
// width: with S = C_out / BN column blocks the work is (16 S + 8) M C^2
// instead of 24 M C^2, i.e. 1x at C = 320 (S = 1), 1.67x at C = 640
// (S = 2) and 3x at C = 1280 (S = 4).  Sharing a hidden tile across a
// thread-block cluster (DSMEM), wgmma, TMA and pipelined tile loads are
// later work; this is the simple form.
//
// Block: 8 warps as 4 row groups of 16 rows x 2 column halves.  Per hidden
// tile of 64: the up-projection streams x and W1 through shared memory in
// 64-wide slices of C (each warp: 16 rows x 32 value + 32 gate columns);
// the down-projection reads the 64 x 64 h tile and a BN x 64 tile of W2
// (each warp: 16 rows x BN/2 output columns).  Rows past M (the ragged
// edge: M = 1200 in the mid block) load as zeros and are not stored.
// Tiles are padded by 8 elements per row so the fragment loads of a warp
// hit 32 distinct banks.
//
// Takes bf16 only, C % 64 == 0, H % 64 == 0, C_out % 16 == 0, 16-byte
// aligned x, W1, W2; anything else is refused with cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBM = 64;        // rows per block
constexpr int kBH = 64;        // hidden columns per tile (value and gate each)
constexpr int kBK = 64;        // slice of C per up-projection step
constexpr int kThreads = 256;  // 8 warps: 4 row groups x 2 column halves
constexpr int kP = 64 + 8;     // shared-memory pitch (elements) of every tile

__device__ __forceinline__ float gelu_tanh(float x) {
  // tanh-approximate gelu in f32 (geglu.py _gelu_tanh)
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// 64 columns [c0, c0 + 64) of `rows` rows of a row-major bf16 matrix (row
// stride ld) into shared memory at pitch kP; src_row(r) maps tile row r to
// a source row, or -1 for a row of zeros
template <typename RowFn>
__device__ __forceinline__ void load_tile64(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            int64_t ld, int c0, int rows, RowFn src_row) {
  for (int i = threadIdx.x; i < rows * 8; i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    const int s = src_row(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s >= 0) val = *reinterpret_cast<const uint4*>(src + s * ld + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * kP + c) = val;
  }
}

// A fragment (16 x 16, rows r0.., columns kk..) of a tile at pitch kP
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int r0,
                                       int kk, int g, int tg) {
  const __nv_bfloat16* p = tile + (r0 + g) * kP + kk + tg * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * kP);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * kP + 8);
}

template <int BN>
__global__ void __launch_bounds__(kThreads) geglu_ffn_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
    const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
    __nv_bfloat16* __restrict__ out, int M, int C, int Hd, int Cout) {
  constexpr int NB = BN / 16;  // output n-tiles (8 columns) per warp
  static_assert(BN % 16 == 0, "each column half is whole n-tiles");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBM][kP]
  __nv_bfloat16* w1s = xs + kBM * kP;                              // [2 kBH][kP]
  __nv_bfloat16* hs = w1s + 2 * kBH * kP;                          // [kBM][kP]
  __nv_bfloat16* w2s = hs + kBM * kP;                              // [BN][kP]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp >> 1, wc = warp & 1;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = wr * 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;

  float acc[NB][4];
#pragma unroll
  for (int t = 0; t < NB; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int j0 = 0; j0 < Hd; j0 += kBH) {  // hidden tiles
    // up-projection: n-tiles 0-3 value, 4-7 gate, hidden columns
    // j0 + wc * 32 + (t % 4) * 8 of this warp's 16 rows
    float up[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) up[t][0] = up[t][1] = up[t][2] = up[t][3] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kBK) {
      __syncthreads();  // every warp is done with the tiles of the last step
      load_tile64(xs, x, C, k0, kBM, [&](int r) { return m0 + r < M ? m0 + r : -1; });
      load_tile64(w1s, w1, C, k0, 2 * kBH,
                  [&](int r) { return r < kBH ? j0 + r : Hd + j0 + r - kBH; });
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t a[4];
        load_a(a, xs, r0, kk, g, tg);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const __nv_bfloat16* wp =
              w1s + ((t >> 2) * kBH + wc * 32 + (t & 3) * 8 + g) * kP + kk + tg * 2;
          mma_16816(up[t], a, ld32(wp), ld32(wp + 8));
        }
      }
    }

    // gate: h = bf16(v * gelu(g)), with the f32 biases, into shared memory
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int col = wc * 32 + t * 8 + tg * 2;  // within the hidden tile
      const float bv0 = __bfloat162float(b1[j0 + col]);
      const float bv1 = __bfloat162float(b1[j0 + col + 1]);
      const float bg0 = __bfloat162float(b1[Hd + j0 + col]);
      const float bg1 = __bfloat162float(b1[Hd + j0 + col + 1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v0 = up[t][2 * i] + bv0, v1 = up[t][2 * i + 1] + bv1;
        const float q0 = up[t + 4][2 * i] + bg0, q1 = up[t + 4][2 * i + 1] + bg1;
        *reinterpret_cast<uint32_t*>(hs + (r0 + g + 8 * i) * kP + col) =
            pack_bf16x2(v0 * gelu_tanh(q0), v1 * gelu_tanh(q1));
      }
    }
    load_tile64(w2s, w2, Hd, j0, BN, [&](int r) { return n0 + r; });
    __syncthreads();

    // down-projection: acc += h W2^T over this hidden tile
#pragma unroll
    for (int kk = 0; kk < kBH; kk += 16) {
      uint32_t a[4];
      load_a(a, hs, r0, kk, g, tg);
#pragma unroll
      for (int t = 0; t < NB; ++t) {
        const __nv_bfloat16* wp = w2s + (wc * (BN / 2) + t * 8 + g) * kP + kk + tg * 2;
        mma_16816(acc[t], a, ld32(wp), ld32(wp + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + r0 + g + 8 * i;
    if (row >= M) continue;
    __nv_bfloat16* orow = out + (int64_t)row * Cout + n0 + wc * (BN / 2) + tg * 2;
#pragma unroll
    for (int t = 0; t < NB; ++t)
      *reinterpret_cast<uint32_t*>(orow + t * 8) = pack_bf16x2(acc[t][2 * i], acc[t][2 * i + 1]);
  }
}

template <int BN>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2, void* out,
                   int M, int C, int Hd, int Cout, cudaStream_t stream) {
  constexpr size_t smem = sizeof(__nv_bfloat16) * (size_t)(kBM + 2 * kBH + kBM + BN) * kP;
  cudaError_t err = cudaFuncSetAttribute(
      geglu_ffn_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + kBM - 1) / kBM, Cout / BN);
  geglu_ffn_kernel<BN><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<__nv_bfloat16*>(out), M, C, Hd, Cout);
  return cudaGetLastError();
}

}  // namespace

// x [M, C], w1 [2 Hd, C], b1 [2 Hd], w2 [Cout, Hd], out [M, Cout]: all
// contiguous bf16.  Returns the launch's cudaError_t (0 on success).
extern "C" int unigeo_geglu_ffn(const void* x, const void* w1, const void* b1, const void* w2,
                                void* out, int M, int C, int Hd, int Cout, void* stream) {
  const uintptr_t ptrs = (uintptr_t)x | (uintptr_t)w1 | (uintptr_t)w2;
  if (M <= 0 || C <= 0 || Hd <= 0 || Cout <= 0 || C % kBK || Hd % kBH || Cout % 16 ||
      ptrs % 16 || (uintptr_t)out % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the widest column block that divides C_out: 320 at every UNet width
  if (Cout % 320 == 0) return (int)launch<320>(x, w1, b1, w2, out, M, C, Hd, Cout, st);
  if (Cout % 128 == 0) return (int)launch<128>(x, w1, b1, w2, out, M, C, Hd, Cout, st);
  if (Cout % 64 == 0) return (int)launch<64>(x, w1, b1, w2, out, M, C, Hd, Cout, st);
  return (int)launch<16>(x, w1, b1, w2, out, M, C, Hd, Cout, st);
}
