// bf16 tensor-core fragments shared by the flash-attention kernels:
// mma.sync m16n8k16 (bf16 in, f32 accumulate) and the packing of its
// operands.  Fragment layout (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// with g = lane / 4 and tg = lane % 4:
//   A (16 x 16, row-major): a0 = (row g, cols 2tg..2tg+1), a1 = (row g+8,
//     same cols), a2 = (row g, cols 2tg+8..2tg+9), a3 = (row g+8, same);
//   B (16 x 8, k x n): b0 = (k 2tg..2tg+1, col g), b1 = (k 2tg+8..2tg+9, col g);
//   C (16 x 8, f32): c0, c1 = (row g, cols 2tg, 2tg+1), c2, c3 = (row g+8, same).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

}  // namespace
