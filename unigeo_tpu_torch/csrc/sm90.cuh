// Hopper (sm_90a) building blocks for the hand-written kernels, in plain
// inline PTX (PTX ISA 8.0; no CUTLASS):
//
// * tensor maps for the TMA, encoded on the host by cuTensorMapEncodeTiled,
//   reached through the runtime's driver entry point (so the library needs
//   no -lcuda); each map goes to its kernel as a
//   `const __grid_constant__ CUtensorMap` parameter;
// * a cache of launch plans per device and sizes (host);
// * mbarriers: init, arrive, arrive.expect_tx, try_wait.parity;
// * the TMA's 3-D tile load into shared memory, and its bulk copy of
//   contiguous bytes (no tensor map), completing on an mbarrier;
// * wgmma: shared-memory matrix descriptors for 128-, 64- and 32-byte
//   swizzled tiles as the TMA writes them, wgmma.mma_async m64nNk16 bf16 ->
//   f32 with A from shared memory or from registers and B K-major or
//   MN-major (the transpose bit), and wgmma.fence / commit_group /
//   wait_group; the proxy fence that lets a wgmma read what threads stored
//   to shared memory;
// * setmaxnreg, to move registers from a producer warpgroup to consumers;
// * named barriers (bar.sync / bar.arrive), to order warpgroups' turns;
// * thread-block clusters: the block's rank, the cluster barrier, an
//   mbarrier arrival on another block's barrier, the TMA load that
//   multicasts one tile to every block of a cluster, and loads from another
//   block's shared memory;
// * cp.async: 16-byte copies from device to shared memory by each thread,
//   zero-filling rows past an edge, in commit groups.
//
// Layouts.  A tile of R rows of W bf16 (row bytes 2W = 128 with the 128-byte
// swizzle, 64 with the 64-byte one, 32 with the 32-byte one), loaded by the
// TMA at a shared address aligned to 1024 bytes, holds element (r, c) at
// byte swizzle(r * 2W + 2c), where swizzle XORs address bits [4, 4+n) with
// bits [7, 7+n) (n = 3 for 128 bytes, 2 for 64, 1 for 32).  As a wgmma operand such a
// tile is K-major when its rows are the product's M or N index and its
// columns the summed index k, and MN-major when its rows are k.  The
// descriptors below encode both, 8-row groups 8 * 2W bytes apart.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no driver call is linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>

namespace sm90 {

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A 3-D map of a packed bf16 tensor [B, S, HD] (rows of HD contiguous
// elements, 16-byte aligned base): dims (HD, S, B), box (width, rows, 1),
// so a load at (h * width, s0, b) brings rows [s0, s0 + rows) of head h of
// batch entry b.  Rows past S come back as zeros.
inline cudaError_t packed_tile_map(CUtensorMap* map, const void* base, int B, int S, int HD,
                                   int width, int rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn;
  cudaError_t err = encode_tiled(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2, (cuuint64_t)S * HD * 2};  // bytes
  const cuuint32_t box[3] = {(cuuint32_t)width, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A launch's plan per key (the device and the sizes), worked out once: a
// plan asks the CUDA runtime for attributes and occupancy, which costs host
// time on every call where it is worked out anew.  `make(&plan)` fills in a plan
// for a key not seen yet; a plan is kept only where it succeeded.
template <typename Key, typename Plan>
class PlanCache {
 public:
  template <typename Make>
  cudaError_t get(const Key& key, Plan* plan, Make make) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      const auto it = plans_.find(key);
      if (it != plans_.end()) {
        *plan = it->second;
        return cudaSuccess;
      }
    }
    const cudaError_t err = make(plan);
    if (err == cudaSuccess) {
      std::lock_guard<std::mutex> lock(mu_);
      plans_.emplace(key, *plan);
    }
    return err;
  }

 private:
  std::mutex mu_;
  std::map<Key, Plan> plans_;
};

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory as a T at the first 1024-byte boundary (the
// launch asks for sizeof(T) + 1024 bytes)
template <typename T>
__device__ __forceinline__ T& aligned_smem(unsigned char* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<T*>(raw + pad);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after every mbar_init of the block, before the barriers are used
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` more of TMA transfers this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// A ring slot and its phase, advanced in the order a producer fills the
// ring: a consumer waits for the slot's full barrier at `phase`, the
// producer for its empty barrier at `phase ^ 1`
struct Ring {
  int slot = 0, phase = 0;
  __device__ __forceinline__ void next(int n) {
    if (++slot == n) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// TMA: the box of `map` at coordinates (c0, c1, c2) into shared `dst`; the
// bytes complete on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// TMA without a tensor map: `bytes` (a multiple of 16) from device memory at
// `src` into shared `dst`, both 16-byte aligned; the bytes complete on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the same, multicast: the box lands at `dst`'s offset in the shared memory
// of every block of the cluster in `mask` (bit i: rank i), and its bytes
// complete on the mbarrier at `bar`'s offset in each of them
__device__ __forceinline__ void tma_load_3d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, uint16_t mask, int c0,
                                                      int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "h"(mask), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// device: clusters
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster: after it, what each did
// before (mbarrier inits included) is visible to all
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// one arrival on the mbarrier at `bar`'s offset in block `rank` of the
// cluster (the arrival's default semantics, release at the block's scope,
// as a consumer frees a slot whose reads its wgmma_wait completed)
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      ::"r"(smem_u32(bar)), "r"(rank) : "memory");
}

// the f32 (4 f32) at `p`'s offset in the shared memory of block `rank` of
// the cluster (after a cluster_sync that follows the peer's stores)
__device__ __forceinline__ float ld_cluster_f32(const float* p, uint32_t rank) {
  float v;
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %1, %2;\n"
      "ld.shared::cluster.f32 %0, [remote];\n}\n"
      : "=f"(v) : "r"(smem_u32(p)), "r"(rank) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_cluster_f32x4(const float* p, uint32_t rank) {
  float4 v;
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %4, %5;\n"
      "ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [remote];\n}\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(smem_u32(p)), "r"(rank) : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// device: cp.async
// ---------------------------------------------------------------------------

// 16 bytes from device memory `src` to shared `dst` (both 16-byte aligned),
// through L2 only; where !ok nothing is read and `dst` gets zeros (`src`
// must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// closes this thread's group of copies issued since the last commit
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// descriptor layout types (bits 62-63)
constexpr uint32_t kSwizzle128B = 1, kSwizzle64B = 2, kSwizzle32B = 3;

// a shared-memory matrix descriptor: start address, leading and stride byte
// offsets (given in bytes, encoded in 16-byte units), layout type
__device__ __forceinline__ uint64_t make_desc(const void* tile, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

// Tiles of rows of W bf16 (W = 64 with the 128-byte swizzle, W = 32 with the
// 64-byte one, W = 16 with the 32-byte one), as written by the TMA.
template <int W>
struct SwizzledTile {
  static_assert(W == 64 || W == 32 || W == 16, "row widths of 128, 64 or 32 bytes");
  static constexpr uint32_t kRowBytes = 2 * W;
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;  // one 8-row swizzle atom
  static constexpr uint32_t kLayout = W == 64 ? kSwizzle128B
                                      : W == 32 ? kSwizzle64B
                                                : kSwizzle32B;

  // K-major operand (rows = M or N, columns = k); k-step i of 16 columns
  // starts 32 bytes further into each row (the leading offset is unused)
  __device__ static uint64_t kmajor(const void* tile, int i) {
    return make_desc(tile, 16, kGroupBytes, kLayout) + (uint64_t)(i * 32 >> 4);
  }
  // MN-major operand (rows = k, columns = N); k-step i of 16 rows starts 16
  // rows further.  N <= W is one swizzle atom wide; a wider N spans atoms
  // of W columns `atom_stride` bytes apart (the leading offset: one TMA box
  // of W columns after another).  The leading offset is unused for N <= W
  // and is then given the 8-row stride.
  __device__ static uint64_t mnmajor(const void* tile, int i,
                                     uint32_t atom_stride = kGroupBytes) {
    return make_desc(tile, atom_stride, kGroupBytes, kLayout) +
           (uint64_t)(i * 16 * kRowBytes >> 4);
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma uses across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define SM90_F8(d, i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_F64(d, i)                                                                 \
  SM90_F8(d, i), SM90_F8(d, i + 8), SM90_F8(d, i + 16), SM90_F8(d, i + 24),            \
      SM90_F8(d, i + 32), SM90_F8(d, i + 40), SM90_F8(d, i + 48), SM90_F8(d, i + 56)
#define SM90_D128 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127" \
  "}"
#define SM90_D32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B for a 64 x N tile, N in {16, 64, 80, 256}, k = 16: A from registers
// (four words per thread: per warp w of the warpgroup, the mma.m16n8k16 A
// layout of rows [16w, 16w + 16)), B by descriptor; TransB = 1 for an
// MN-major B.  scale_d = 0 overwrites d.  The accumulator d holds, per warp
// w and lane (g, tg) = (lane / 4, lane % 4), d[4j + e] = element
// (16w + g + 8 (e >> 1), 8j + 2tg + (e & 1)); its columns 16i..16i+15 are
// the A registers of k-step i of a next product once rounded to bf16.
// Registers given as A are read while the wgmma runs: keep them unchanged
// until wgmma_wait, and give A from shared memory (wgmma_ss64) for an
// operand that stays the same across a loop (ptxas 12.9 reassigned such
// loop-carried A registers inside the loop).
template <int N, int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
        : SM90_F8(d, 0), SM90_F8(d, 8), SM90_F8(d, 16), SM90_F8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TransB), "r"(scale_d));
  } else if constexpr (N == 80) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %46, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39}"
        ", {%40, %41, %42, %43}, %44, p, 1, 1, %45;\n}\n"
        : SM90_F8(d, 0), SM90_F8(d, 8), SM90_F8(d, 16), SM90_F8(d, 24), SM90_F8(d, 32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TransB), "r"(scale_d));
  } else if constexpr (N == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %134, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SM90_D128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, %133;\n}\n"
        : SM90_F64(d, 0), SM90_F64(d, 64)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TransB), "r"(scale_d));
  } else {
    static_assert(N == 16, "wgmma_rs: N = 16, 64, 80 or 256");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %13;\n}\n"
        : SM90_F8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TransB), "r"(scale_d));
  }
}

// the same with A from shared memory by descriptor (TransA = 1 for an
// MN-major A), N = 64
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", %32, %33, p, 1, 1, %34, %35;\n}\n"
      : SM90_F8(d, 0), SM90_F8(d, 8), SM90_F8(d, 16), SM90_F8(d, 24)
      : "l"(da), "l"(db), "n"(TransA), "n"(TransB), "r"(scale_d));
}

// d (+)= A B for a 64 x 32 tile, k = 16, both operands K-major from shared
// memory by descriptor (the d = 512 forward's partial S over a 32-key tile)
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : SM90_F8(d, 0), SM90_F8(d, 8)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A B for a 64 x 128 tile, k = 16, both operands K-major from shared
// memory by descriptor (the forward's S = q k^T over a 128-key tile).  The
// accumulator layout is wgmma_rs's with j in [0, 16).
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_F8(d, 0), SM90_F8(d, 8), SM90_F8(d, 16), SM90_F8(d, 24), SM90_F8(d, 32),
        SM90_F8(d, 40), SM90_F8(d, 48), SM90_F8(d, 56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A B for a 64 x N tile, k = 16, both operands K-major from shared
// memory by descriptor, N in {8, 32, 64, 128, 160}.  The accumulator layout
// is wgmma_rs's with j in [0, N / 8).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) {
    wgmma_ss64<0, 0>(d, da, db, scale_d);
  } else if constexpr (N == 32) {
    wgmma_ss32(d, da, db, scale_d);
  } else if constexpr (N == 128) {
    wgmma_ss128(d, da, db, scale_d);
  } else if constexpr (N == 160) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
        "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
        "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}"
        ", %80, %81, p, 1, 1, 0, 0;\n}\n"
        : SM90_F8(d, 0), SM90_F8(d, 8), SM90_F8(d, 16), SM90_F8(d, 24), SM90_F8(d, 32),
          SM90_F8(d, 40), SM90_F8(d, 48), SM90_F8(d, 56), SM90_F8(d, 64), SM90_F8(d, 72)
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    static_assert(N == 8, "wgmma_ss: N = 8, 32, 64, 128 or 160");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// after threads' stores to shared memory that a wgmma (the async proxy)
// reads next: each storing thread runs it before the barrier that orders
// the stores before the wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#undef SM90_F64
#undef SM90_F8
#undef SM90_D128
#undef SM90_D32

// named barriers (ids 1-15; __syncthreads uses 0): `count` threads, a
// multiple of 32, arrive in all, some syncing (waiting), some only arriving
template <int Count>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(Count) : "memory");
}
template <int Count>
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(Count) : "memory");
}

// registers per thread of the warpgroup that runs it (a multiple of 8 in
// [24, 256]); all four warps of the warpgroup run it together
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

}  // namespace sm90
