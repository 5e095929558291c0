// Fused GEGLU feed-forward for Hopper (sm_90a), bf16.
//
// Replaces: unigeo_tpu/ops/geglu.py::geglu_ffn_tpu (Pallas kernel
// _geglu_kernel).  For x [M, C] it computes
//
//   v = x W1v^T + b1v,  g = x W1g^T + b1g      (f32 accumulate, f32 bias)
//   h = bf16(v * gelu_tanh(g))                  (gelu in f32, h rounded once)
//   out = bf16(sum over hidden tiles of h W2^T) (f32 accumulate, no b2)
//
// in the port's own weight layout, with no transpose copy (the fused pass
// keeps h in shared memory; the two-pass plan below writes it once to a
// bf16 scratch [M, H] and reads it back): W1 is
// net.0.proj.weight [2H, C] (rows [0, H) the value, [H, 2H) the gate, the
// JAX package's w1[:, :H] and w1[:, H:]), b1 its bias [2H], W2 is
// net.2.weight [C_out, H].  An nn.Linear weight [out, in] is a K-major B
// operand of wgmma for x W^T as it lies, so tiles of W1 and W2 are loaded
// by the TMA as they lie.
//
// What bounds it on the H100: 24 M C^2 operations (C_out = C, H = 4C)
// against 2 (M C + 8 C^2 + M C) bytes of bf16 (x, W1, W2 and out; b1 is
// negligible): about 3000 operations per byte at the UNet's first stage
// (M = 76800, C = 320), ten times the ~295 at which the tensor cores
// (989 TF/s bf16) and not memory (3.35 TB/s) are the limit.  The bound is
// the operations at every main-path shape.  Inside the kernel the weights
// are the traffic: every item of 64 rows streams all of W1 and W2 from L2
// into shared memory, 64 operations per byte of L2 traffic, and the
// tensor cores read each operand from shared memory again.
//
// What this design does about it (geglu_ffn_wgmma_kernel<CW, MODE>): both
// products run on the tensor cores as wgmma m64nNk16 (bf16 in, f32
// accumulate) with both operands from shared memory, fed by the TMA.  A
// block is a producer warpgroup (setmaxnreg 40) and two consumer
// warpgroups (232 registers); blocks run in clusters of two, each block
// taking its own 64 rows while the pair shares every weight tile: each
// block loads half of a tile and multicasts it to both, and a ring slot is
// refilled once the consumers of both blocks freed it (remote mbarrier
// arrivals).  At most one cluster per pair of SMs walks over items (the
// walk is sized by the card's occupancy for clusters).  An item is a pair
// of row blocks x one column group of 2 CW output columns x one split of
// the hidden tiles; consumer c owns output columns [c CW, c CW + CW) of the
// group (CW / 2 f32 accumulator registers a thread).  Per hidden tile of 64:
//
//   * up-projection: consumer c computes the value and gate columns of its
//     half of the tile, [32c, 32c + 32), as one m64n64 product per k-step
//     (B = 32 value rows then 32 gate rows of W1, TMA boxes of 32 rows a
//     64-column slice of C); x comes from shared memory (loaded once per
//     item where it fits beside four W1 slices, C = 320; otherwise a
//     64-column slice rides with each W1 slice);
//   * gate: h = bf16(v gelu_tanh(g)) (tanhf, f32 biases) into its half of
//     a shared 64 x 64 h tile, stored in the 128-byte swizzle a wgmma reads
//     as a K-major A operand; a proxy fence and one named barrier of the
//     two consumers per tile (two h buffers: a buffer is written again
//     only after both consumers' products that read it completed);
//   * down-projection: both consumers run acc += h W2^T over the whole h
//     tile, W2 in 32-column chunks (64-byte swizzle) of the group's rows,
//     m64n160 (or narrower) products, left running while the next tile's
//     up-projection is issued.
//
// That fused pass (MODE kFused) is the plan at C_out = 320 (UNet stage 0,
// CW = 160, x resident).  Where a consumer's columns would be 320 (C_out =
// 640) or one block's 640 columns do not cover C_out (1280: two groups,
// the up-projection computed twice, (16 S + 8) / 24 of the useful work
// with S groups), the launch is two passes of the same kernel: kUp (the
// up-projection and gate as above but in hidden tiles of 128, each
// consumer's half an m64n128 product, since no output accumulator sits
// beside it; h written to a bf16 [M, H] scratch in device memory, the
// hidden tiles split over items for parallelism) and
// kDown (h tiles loaded by the TMA into the h buffers, the
// down-projection as above over a deeper W2 ring).  Both round h to bf16
// once and the output once, as the fused pass does; the two passes move
// 2 M H (1 + S) bytes of h more and compute each product once
// (tools/ffn_variants.py times the fused and two-pass forms per shape).
// Where the items would not fill the clusters evenly (the mid block: 19
// row blocks), the hidden tiles of the fused or down pass are split over
// items; each split writes its f32 partial output into a scratch buffer
// the caller allocates, and geglu_split_sum_kernel sums the splits in a
// fixed order and rounds once to bf16 (no atomics: two launches give the
// same bits).
//
// Rows past M (the ragged edge: M = 1200 in the mid block) are loaded as
// zeros by the TMA and not stored.  Takes bf16 only, C % 64 == 0,
// H % 64 == 0, C_out % 16 == 0, 16-byte aligned x, W1, W2 and a 4-byte
// aligned out; anything else is refused with cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <array>
#include <initializer_list>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

constexpr int kRows = 64;           // rows of an item
constexpr int kHT = 64;             // hidden columns of a tile
constexpr int kKBox = 64;           // columns of C in an up-projection slice
constexpr int kW2Cols = 32;         // hidden columns of a down-projection chunk
constexpr int kThreads = 384;       // a producer warpgroup and two consumers
constexpr int kCluster = 2;         // blocks of a cluster: row blocks sharing weight tiles (1 or 2)
constexpr uint16_t kAll = (1u << kCluster) - 1;  // a multicast to every block of the cluster
// setmaxnreg: the producer gives up what the consumers take, (168 - 40) x 128
// = (232 - 168) x 256 registers of the 168 a thread the launch holds
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMaxStages = 8;
constexpr int kHBytes = kRows * kHT * 2;        // one h tile
constexpr int kHTiles = 2;                      // h buffers
constexpr int kXBox = kRows * kKBox * 2;        // one 64-column slice of x
constexpr int kPlanInts = 14;
constexpr int kMaxSplits = 8;    // hidden splits the plan considers for a sum of partials
constexpr int kMaxUpSplits = 16;  // hidden splits of the up-projection pass
constexpr int kXresSlices = 4;   // the least up ring beside a resident x
// the plan's estimates: an SM's rate on an item's tile (flops per us, about
// half the bf16 peak) and the rate of the splits' f32 partials (bytes per
// us, about the memory's rate)
constexpr double kTileFlopsPerUs = 3.4e6, kPartialBytesPerUs = 3.0e6;

// What a launch of the kernel computes: the fused feed-forward; or, as two
// passes, the up-projection with the gate writing h to device memory, then
// the down-projection reading it
enum Mode { kFused = 0, kUp = 1, kDown = 2 };

// hidden columns a consumer's up-projection takes per tile (value and gate:
// an m64n(2 kUpCols) product), and the hidden tile of the up-projection: the
// up pass, with no output accumulator beside it, takes twice the fused
// pass's columns
template <int MODE>
constexpr int kUpCols = MODE == kUp ? 64 : 32;
template <int MODE>
constexpr int kUpTile = 2 * kUpCols<MODE>;
// bytes of a W1 slice: value and gate rows of both consumers, 64 columns of C
__host__ __device__ constexpr int w1_slice_bytes(int up_cols) { return 2 * 2 * up_cols * kKBox * 2; }

using Tile128 = sm90::SwizzledTile<64>;  // x, W1, h: 128-byte rows
using Tile64 = sm90::SwizzledTile<32>;   // W2 chunks: 64-byte rows

__device__ __forceinline__ float gelu_tanh(float x) {
  // tanh-approximate gelu in f32 (geglu.py _gelu_tanh)
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// One pass's shape: CW output columns a consumer, column groups, hidden
// splits, x resident or streamed, ring depths, items, blocks, shared memory
struct Pass {
  int cw, groups, splits, xres, nsu, nsw, items, blocks, smem;
};

// The plan of a launch: the fused pass, or (two_pass) the up-projection
// pass `up` and the down-projection pass `main`
struct Plan {
  Pass main, up;
  int two_pass;
};

// Byte offsets of the dynamic shared memory (from a 1024-byte boundary):
// the two h tiles, the W2 ring, the up ring (x slice then W1 slice per
// slot, or W1 only with x resident), x resident, then the mbarriers
struct Layout {
  int w2, up, up_slot, x, bars, total;
  __host__ __device__ Layout(int cw, int up_cols, int C, int xres, int nsu, int nsw) {
    const int w2_slot = 2 * cw * kW2Cols * 2;
    up_slot = w1_slice_bytes(up_cols) + (xres ? 0 : kXBox);
    w2 = kHTiles * kHBytes;
    up = w2 + nsw * w2_slot;
    x = up + nsu * up_slot;
    bars = x + (xres ? (C / kKBox) * kXBox : 0);
    total = bars + (4 * kMaxStages + 2 + 2 * kHTiles) * 8;
  }
};

struct Bars {
  uint64_t up_full[kMaxStages], up_empty[kMaxStages], w2_full[kMaxStages],
      w2_empty[kMaxStages], x_full, x_empty, h_full[kHTiles], h_empty[kHTiles];
};

// a cluster's item -> (pair of row blocks, column group, hidden split),
// splits fastest; block `rank` of the cluster takes row block 2 pair + rank
struct Item {
  int m0, n0, t0, t1, split;
  __device__ __forceinline__ Item(int item, int rank, int cw, int groups, int splits,
                                  int n_tiles) {
    split = item % splits;
    const int rest = item / splits;
    n0 = rest % groups * 2 * cw;
    m0 = (rest / groups * kCluster + rank) * kRows;
    t0 = split * n_tiles / splits;
    t1 = (split + 1) * n_tiles / splits;
  }
};

template <int CW>
struct Shape {
  static constexpr int kChunk = CW < 160 ? CW : 160;  // columns of a down-projection product
  static constexpr int kChunks = CW / kChunk;
  static_assert(CW % kChunk == 0, "whole products");
};

template <int CW, int MODE>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    geglu_ffn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_w1,
                           const __grid_constant__ CUtensorMap tm_w2,
                           const __grid_constant__ CUtensorMap tm_h,
                           const __nv_bfloat16* __restrict__ b1, __nv_bfloat16* __restrict__ out,
                           float* __restrict__ partial, __nv_bfloat16* __restrict__ hbuf, int M,
                           int C, int Hd, int Cout, int groups, int splits, int xres, int nsu,
                           int nsw) {
  using S = Shape<CW>;
  constexpr int NC = S::kChunk;
  constexpr int kW2Rows = 2 * CW / kCluster;  // rows of a W2 chunk a block loads
  constexpr bool kUpPass = MODE != kDown, kDownPass = MODE != kUp;
  constexpr int UC = kUpCols<MODE>, UT = kUpTile<MODE>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = &sm90::aligned_smem<unsigned char>(smem_raw);
  const Layout lay(CW, UC, C, xres, nsu, nsw);
  Bars& bars = *reinterpret_cast<Bars*>(base + lay.bars);
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int rank = (int)sm90::cluster_rank();
  const int cl = blockIdx.x / kCluster, n_cl = gridDim.x / kCluster;
  // hidden tiles: of the up-projection (UT) where it runs, else of 64
  const int n_kb = C / kKBox, n_tiles = Hd / (kUpPass ? UT : kHT);
  const int n_items = (M + kCluster * kRows - 1) / (kCluster * kRows) * groups * splits;
  const auto h_tile = [&](int i) { return reinterpret_cast<__nv_bfloat16*>(base + i * kHBytes); };
  const auto w2_slot = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(base + lay.w2 + s * 2 * CW * kW2Cols * 2);
  };
  const auto up_slot = [&](int s) { return base + lay.up + s * lay.up_slot; };
  const auto x_box = [&](int s, int kb) {
    return reinterpret_cast<__nv_bfloat16*>(xres ? base + lay.x + kb * kXBox : up_slot(s));
  };
  const auto w1_slice = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(up_slot(s) + (xres ? 0 : kXBox));
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      sm90::mbar_init(&bars.up_full[s], 1);
      // a slot is refilled in both blocks at once: one arrival per
      // consumer warp of the cluster
      sm90::mbar_init(&bars.up_empty[s], 8 * kCluster);
      sm90::mbar_init(&bars.w2_full[s], 1);
      sm90::mbar_init(&bars.w2_empty[s], 8 * kCluster);
    }
    sm90::mbar_init(&bars.x_full, 1);
    sm90::mbar_init(&bars.x_empty, 8);  // one arrival per consumer warp of the block
    for (int b = 0; b < kHTiles; ++b) {
      sm90::mbar_init(&bars.h_full[b], 1);
      sm90::mbar_init(&bars.h_empty[b], 8);
    }
    sm90::fence_barrier_init();
  }
  sm90::cluster_sync();  // both blocks' barriers are initialized

  if (wg == 0) {
    // producer: one thread issues every TMA load, in the order the
    // consumers take them: per hidden tile its up-projection slices (or,
    // in the down-projection pass, its h tile), then its two W2 chunks.
    // Block `rank` loads its share of each weight tile (with two blocks:
    // consumer `rank`'s W1 rows, W2 rows [rank CW, rank CW + CW)) and
    // multicasts it to every block; x and h are each block's own.
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::Ring up, w2, hr;
      int xi = 0;
      for (int it = cl; it < n_items; it += n_cl) {
        const Item item(it, rank, CW, groups, splits, n_tiles);
        if (kUpPass && xres) {
          sm90::mbar_wait(&bars.x_empty, (xi++ & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&bars.x_full, n_kb * kXBox);
          for (int kb = 0; kb < n_kb; ++kb)
            sm90::tma_load_3d(x_box(0, kb), &tm_x, &bars.x_full, kb * kKBox, item.m0, 0);
        }
        for (int j = item.t0; j < item.t1; ++j) {
          for (int kb = 0; kb < n_kb && kUpPass; ++kb, up.next(nsu)) {
            sm90::mbar_wait(&bars.up_empty[up.slot], up.phase ^ 1);
            uint64_t* full = &bars.up_full[up.slot];
            sm90::mbar_arrive_expect_tx(full, lay.up_slot);
            if (!xres) sm90::tma_load_3d(x_box(up.slot, kb), &tm_x, full, kb * kKBox, item.m0, 0);
            for (int c = rank; c < 2; c += kCluster) {  // consumer c's UC value, UC gate rows
              __nv_bfloat16* w1s = w1_slice(up.slot) + c * 2 * UC * kKBox;
              const int h0 = j * UT + UC * c;
              sm90::tma_load_3d_multicast(w1s, &tm_w1, full, kAll, kb * kKBox, h0, 0);
              sm90::tma_load_3d_multicast(w1s + UC * kKBox, &tm_w1, full, kAll, kb * kKBox,
                                          Hd + h0, 0);
            }
          }
          if (MODE == kDown) {
            sm90::mbar_wait(&bars.h_empty[hr.slot], hr.phase ^ 1);
            sm90::mbar_arrive_expect_tx(&bars.h_full[hr.slot], kHBytes);
            sm90::tma_load_3d(h_tile(hr.slot), &tm_h, &bars.h_full[hr.slot], j * kHT, item.m0, 0);
            hr.next(kHTiles);
          }
          for (int hc = 0; hc < kHT / kW2Cols && kDownPass; ++hc, w2.next(nsw)) {
            sm90::mbar_wait(&bars.w2_empty[w2.slot], w2.phase ^ 1);
            uint64_t* full = &bars.w2_full[w2.slot];
            sm90::mbar_arrive_expect_tx(full, 2 * CW * kW2Cols * 2);
            for (int r = rank * kW2Rows; r < (rank + 1) * kW2Rows; r += NC)
              sm90::tma_load_3d_multicast(w2_slot(w2.slot) + r * kW2Cols, &tm_w2, full, kAll,
                                          j * kHT + hc * kW2Cols, item.n0 + r, 0);
          }
        }
      }
    }
    __syncwarp();
    sm90::cluster_sync();  // the peer no longer arrives on this block's barriers
    return;
  }

  // consumer c: output columns [c CW, c CW + CW) of each item's group
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1, w = (threadIdx.x / 32) % 4, g = lane / 4, tg = lane % 4;
  const auto arrive = [&](uint64_t* bar) {  // one arrival per warp
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(bar);
  };
  // a slot of every block of the cluster: one arrival per warp on each
  const auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0)
      sm90::mbar_arrive(bar);
    else if (lane < kCluster)
      sm90::mbar_arrive_cluster(bar, rank ^ lane);
  };
  sm90::Ring up, w2, hr, up_free, w2_free, h_free;
  const auto free_up = [&] {
    release(&bars.up_empty[up_free.slot]);
    up_free.next(nsu);
  };
  const auto free_down = [&] {  // both W2 chunks of a tile (and its h tile, loaded)
    for (int hc = 0; hc < kHT / kW2Cols; ++hc) {
      release(&bars.w2_empty[w2_free.slot]);
      w2_free.next(nsw);
    }
    if (MODE == kDown) {
      arrive(&bars.h_empty[h_free.slot]);
      h_free.next(kHTiles);
    }
  };
  int xi = 0, ht = 0;  // items with x resident so far; h tiles so far

  for (int it = cl; it < n_items; it += n_cl) {
    const Item item(it, rank, CW, groups, splits, n_tiles);
    float acc[S::kChunks][NC / 2];
#pragma unroll
    for (int k = 0; k < S::kChunks; ++k)
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) acc[k][i] = 0.f;
    float upa[UC];
    bool pending = false;  // the last tile's down-projection chunks are not freed yet
    if (kUpPass && xres) sm90::mbar_wait(&bars.x_full, xi++ & 1);

    for (int j = item.t0; j < item.t1; ++j, ++ht) {
      if constexpr (kUpPass) {
        // up-projection: value and gate of hidden columns j UT + UC c + [0, UC)
        for (int kb = 0; kb < n_kb; ++kb, up.next(nsu)) {
          sm90::mbar_wait(&bars.up_full[up.slot], up.phase);
          sm90::fence_regs(upa);
          sm90::wgmma_fence();
          const __nv_bfloat16* xs = x_box(up.slot, kb);
          const __nv_bfloat16* w1s = w1_slice(up.slot) + c * 2 * UC * kKBox;
#pragma unroll
          for (int ks = 0; ks < kKBox / 16; ++ks)
            sm90::wgmma_ss<2 * UC>(upa, Tile128::kmajor(xs, ks), Tile128::kmajor(w1s, ks),
                                   kb > 0 || ks > 0);
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();  // the previous group: the last tile's down-projection or slice
          if (kb == 0) {
            if (pending) free_down();
            pending = false;
          } else {
            free_up();
          }
        }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(upa);
        free_up();
        if (xres && j == item.t1 - 1) arrive(&bars.x_empty);

        // gate: h = bf16(v gelu(g)), this consumer's half of the tile, into
        // h tile ht % 2 (two buffers: the one written here was last read by
        // the tile before last, whose down-projection both consumers
        // completed before the last tile's barrier) or, in the up pass, into
        // h in device memory (rows past M are not stored)
        unsigned char* hs = reinterpret_cast<unsigned char*>(h_tile(ht % kHTiles));
#pragma unroll
        for (int jj = 0; jj < UC / 8; ++jj) {
          const int col = UC * c + 8 * jj + 2 * tg;  // within the tile
          const int hcol = j * UT + col;
          const float bv0 = __bfloat162float(b1[hcol]), bv1 = __bfloat162float(b1[hcol + 1]);
          const float bg0 = __bfloat162float(b1[Hd + hcol]);
          const float bg1 = __bfloat162float(b1[Hd + hcol + 1]);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = 16 * w + g + 8 * i;
            const float v0 = upa[4 * jj + 2 * i] + bv0, v1 = upa[4 * jj + 2 * i + 1] + bv1;
            const float q0 = upa[4 * (jj + UC / 8) + 2 * i] + bg0;
            const float q1 = upa[4 * (jj + UC / 8) + 2 * i + 1] + bg1;
            const uint32_t hv = pack_bf16x2(v0 * gelu_tanh(q0), v1 * gelu_tanh(q1));
            if (MODE == kFused) {
              *reinterpret_cast<uint32_t*>(hs + row * 128 + ((2 * col) ^ ((row & 7) << 4))) = hv;
            } else if (item.m0 + row < M) {
              *reinterpret_cast<uint32_t*>(hbuf + (int64_t)(item.m0 + row) * Hd + hcol) = hv;
            }
          }
        }
      }
      if constexpr (MODE == kFused) {
        sm90::fence_proxy_async();
        sm90::bar_sync<256>(1);  // both halves of h are in
      }
      if constexpr (MODE == kDown) sm90::mbar_wait(&bars.h_full[hr.slot], hr.phase);

      if constexpr (kDownPass) {
        // down-projection: acc += h W2^T over this tile, one group of wgmma
        // left running under the next tile's up-projection (fused) or load
        const __nv_bfloat16* hts = h_tile(MODE == kFused ? ht % kHTiles : hr.slot);
        for (int hc = 0; hc < kHT / kW2Cols; ++hc, w2.next(nsw)) {
          sm90::mbar_wait(&bars.w2_full[w2.slot], w2.phase);
#pragma unroll
          for (int k = 0; k < S::kChunks; ++k) sm90::fence_regs(acc[k]);
          sm90::wgmma_fence();
          const __nv_bfloat16* w2s = w2_slot(w2.slot) + c * CW * kW2Cols;
#pragma unroll
          for (int ks = 0; ks < kW2Cols / 16; ++ks)
#pragma unroll
            for (int k = 0; k < S::kChunks; ++k)
              sm90::wgmma_ss<NC>(acc[k], Tile128::kmajor(hts, 2 * hc + ks),
                                 Tile64::kmajor(w2s + k * NC * kW2Cols, ks), 1);
        }
        sm90::wgmma_commit();
        if constexpr (MODE == kDown) {
          hr.next(kHTiles);
          sm90::wgmma_wait<1>();  // the last tile's down-projection
          if (pending) free_down();
        }
        pending = true;
      }
    }
    if constexpr (kDownPass) {
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int k = 0; k < S::kChunks; ++k) sm90::fence_regs(acc[k]);
      if (pending) free_down();

      // this thread's rows 16w + g and + 8; rows past M are not stored
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = item.m0 + 16 * w + g + 8 * i;
        if (row >= M) continue;
        const int64_t col0 = item.n0 + c * CW + 2 * tg;
        if (splits == 1) {
          __nv_bfloat16* orow = out + (int64_t)row * Cout + col0;
#pragma unroll
          for (int k = 0; k < S::kChunks; ++k)
#pragma unroll
            for (int jj = 0; jj < NC / 8; ++jj)
              *reinterpret_cast<uint32_t*>(orow + k * NC + 8 * jj) =
                  pack_bf16x2(acc[k][4 * jj + 2 * i], acc[k][4 * jj + 2 * i + 1]);
        } else {
          float* prow = partial + ((int64_t)item.split * M + row) * Cout + col0;
#pragma unroll
          for (int k = 0; k < S::kChunks; ++k)
#pragma unroll
            for (int jj = 0; jj < NC / 8; ++jj)
              *reinterpret_cast<float2*>(prow + k * NC + 8 * jj) =
                  make_float2(acc[k][4 * jj + 2 * i], acc[k][4 * jj + 2 * i + 1]);
        }
      }
    }
  }
  sm90::cluster_sync();  // the peer no longer arrives on this block's barriers
}

// out = bf16(partial[0] + partial[1] + ... + partial[splits - 1]), the
// splits summed in this order in f32; n = M C_out, a multiple of 4
__global__ void geglu_split_sum_kernel(const float* __restrict__ partial,
                                       __nv_bfloat16* __restrict__ out, int64_t n, int splits) {
  for (int64_t i = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x); i < n;
       i += 4 * (int64_t)gridDim.x * blockDim.x) {
    float4 s = *reinterpret_cast<const float4*>(partial + i);
    for (int sp = 1; sp < splits; ++sp) {
      const float4 p = *reinterpret_cast<const float4*>(partial + sp * n + i);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    uint32_t* o = reinterpret_cast<uint32_t*>(out + i);
    o[0] = pack_bf16x2(s.x, s.y);
    o[1] = pack_bf16x2(s.z, s.w);
  }
}

// the kernel at CW, MODE; the up pass keeps no output accumulator (CW 8)
template <int CW, int MODE>
auto kernel_of() {
  return geglu_ffn_wgmma_kernel<MODE == kUp ? 8 : CW, MODE>;
}

// clusters of the kernel the card holds at once with `smem` bytes a block;
// the kernel may take up to `smem_max` (the device's most), so that every
// plan kept for it launches
template <int CW, int MODE>
cudaError_t cluster_slots(int smem, int smem_max, int* slots) {
  const auto kern = kernel_of<CW, MODE>();
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(slots, (const void*)kern, &cfg);
  return err == cudaSuccess && *slots < 1 ? cudaErrorInvalidConfiguration : err;
}

template <int MODE>
cudaError_t cluster_slots(int cw, int smem, int smem_max, int* slots) {
  switch (cw) {
    case 320: return cluster_slots<320, MODE>(smem, smem_max, slots);
    case 160: return cluster_slots<160, MODE>(smem, smem_max, slots);
    case 64: return cluster_slots<64, MODE>(smem, smem_max, slots);
    case 32: return cluster_slots<32, MODE>(smem, smem_max, slots);
    default: return cluster_slots<8, MODE>(smem, smem_max, slots);
  }
}

// output columns of a consumer: the widest of 320, 160, 64, 32, 8 whose
// pair divides C_out
int consumer_columns(int Cout) {
  for (int cw : {320, 160, 64, 32})
    if (Cout % (2 * cw) == 0) return cw;
  return 8;
}

// The hidden splits whose estimated time is least for `base` cluster items
// of `n_tiles` tiles on `slots` clusters: the busiest cluster's tiles of
// `tile_us`, plus `part_us` for each split's f32 partial where they are
// summed (0 where the splits write disjoint outputs)
int best_splits(int64_t base, int n_tiles, int slots, double tile_us, double part_us,
                int max_splits) {
  int splits = 1;
  double best = 0;
  for (int s = 1; s <= n_tiles && s <= max_splits; ++s) {
    const double waves = (double)((base * s + slots - 1) / slots);
    const double cost = waves * ((n_tiles + s - 1) / s) * tile_us + (s > 1 ? s * part_us : 0.0);
    if (s == 1 || cost < best) best = cost, splits = s;
  }
  return splits;
}

// one pass's rings and shared memory: x resident where it fits beside
// kXresSlices W1 slices, else x streamed with them, the up ring as deep as
// the rest leaves room for (none in the down pass); the W2 ring (none in the
// up pass) one tile's two chunks beside an up ring, as deep as fits in the
// down pass (a tile's chunks are freed once the next tile's are issued)
template <int MODE>
cudaError_t size_pass(int C, int budget, Pass* p) {
  constexpr int UC = kUpCols<MODE>;
  p->xres = 0;
  p->nsu = 0;
  p->nsw = 0;
  if (MODE == kDown) {
    const int nsw = (budget - Layout(p->cw, UC, C, 0, 0, 0).total) / (2 * p->cw * kW2Cols * 2);
    if (nsw < 4) return cudaErrorInvalidValue;
    p->nsw = nsw < kMaxStages ? nsw : kMaxStages;
  } else {
    p->nsw = MODE == kFused ? 2 : 0;
    for (int xres = 1; xres >= 0 && p->nsu == 0; --xres) {
      const int fixed = Layout(p->cw, UC, C, xres, 0, p->nsw).total;
      const int nsu = (budget - fixed) / Layout(p->cw, UC, C, xres, 1, p->nsw).up_slot;
      if (nsu >= (xres ? kXresSlices : 3)) {
        p->xres = xres;
        p->nsu = nsu < kMaxStages ? nsu : kMaxStages;
      }
    }
    if (p->nsu == 0) return cudaErrorInvalidValue;
  }
  p->smem = Layout(p->cw, UC, C, p->xres, p->nsu, p->nsw).total + 1024;
  return cudaSuccess;
}

// The plan of a launch at (M, C, H, C_out) on device `dev`.  Two passes
// where a consumer's columns are 320 or one block's do not cover C_out
// (C_out > 320): there the fused body's 160-register accumulators leave its
// up-projection a shallow ring (C_out = 640) or it computes the
// up-projection once per column group (C_out = 1280); measured at the
// UNet's shapes (tools/ffn_variants.py).
cudaError_t make_plan(int dev, int M, int C, int Hd, int Cout, Plan* p) {
  int smem_max, slots;
  cudaError_t err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int budget = smem_max - 1024;  // the launch asks 1024 more for the alignment
  const int n_tiles = Hd / kHT;
  const int64_t pairs = (M + kCluster * kRows - 1) / (kCluster * kRows);
  Pass& m = p->main;
  m.cw = consumer_columns(Cout);
  m.groups = Cout / (2 * m.cw);
  p->two_pass = (m.groups > 1 || m.cw > 160) && Hd % kUpTile<kUp> == 0;
  p->up = Pass{};
  if (p->two_pass) {
    Pass& u = p->up;
    u.cw = 8;
    u.groups = 1;
    if ((err = size_pass<kUp>(C, budget, &u)) != cudaSuccess ||
        (err = cluster_slots<kUp>(u.cw, u.smem, smem_max, &slots)) != cudaSuccess)
      return err;
    u.splits = best_splits(pairs, Hd / kUpTile<kUp>, slots, 1.0, 0.0, kMaxUpSplits);
    u.items = (int)(pairs * u.splits);
    u.blocks = kCluster * (u.items < slots ? u.items : slots);
    err = size_pass<kDown>(C, budget, &m);
    if (err == cudaSuccess) err = cluster_slots<kDown>(m.cw, m.smem, smem_max, &slots);
  } else {
    err = size_pass<kFused>(C, budget, &m);
    if (err == cudaSuccess) err = cluster_slots<kFused>(m.cw, m.smem, smem_max, &slots);
  }
  if (err != cudaSuccess) return err;
  const int64_t base = pairs * m.groups;
  const double flops = (p->two_pass ? 0.0 : 4.0 * kRows * C * kHT) + 2.0 * kRows * kHT * 2 * m.cw;
  m.splits = best_splits(base, n_tiles, slots, flops / kTileFlopsPerUs,
                         8.0 * M * Cout / kPartialBytesPerUs, kMaxSplits);
  const int64_t items = base * m.splits;
  if (items > INT32_MAX) return cudaErrorInvalidValue;
  m.items = (int)items;
  m.blocks = kCluster * (items < slots ? (int)items : slots);
  return cudaSuccess;
}

template <int CW, int MODE>
cudaError_t launch_pass(const Pass& p, const CUtensorMap& tx, const CUtensorMap& tw1,
                        const CUtensorMap& tw2, const CUtensorMap& th, const void* b1, void* out,
                        float* partial, void* hbuf, int M, int C, int Hd, int Cout,
                        cudaStream_t stream) {
  kernel_of<CW, MODE>()<<<p.blocks, kThreads, p.smem, stream>>>(
      tx, tw1, tw2, th, static_cast<const __nv_bfloat16*>(b1), static_cast<__nv_bfloat16*>(out),
      partial, static_cast<__nv_bfloat16*>(hbuf), M, C, Hd, Cout, p.groups, p.splits, p.xres,
      p.nsu, p.nsw);
  return cudaGetLastError();
}

template <int CW>
cudaError_t launch(const Plan& p, const void* x, const void* w1, const void* b1,
                   const void* w2, void* out, float* partial, void* hbuf, int M, int C, int Hd,
                   int Cout, cudaStream_t stream) {
  constexpr int NC = Shape<CW>::kChunk;
  CUtensorMap tx, tw1, tw2, th;
  cudaError_t err;
  // W1 in boxes of a consumer's value (or gate) rows of a tile
  const int w1_rows = p.two_pass ? kUpCols<kUp> : kUpCols<kFused>;
  if ((err = sm90::packed_tile_map(&tx, x, 1, M, C, kKBox, kRows,
                                   CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = sm90::packed_tile_map(&tw1, w1, 1, 2 * Hd, C, kKBox, w1_rows,
                                   CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = sm90::packed_tile_map(&tw2, w2, 1, Cout, Hd, kW2Cols, NC,
                                   CU_TENSOR_MAP_SWIZZLE_64B)) != cudaSuccess)
    return err;
  th = tx;  // the fused pass reads no h from device memory
  if (p.two_pass) {
    if ((err = sm90::packed_tile_map(&th, hbuf, 1, M, Hd, kHT, kRows,
                                     CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
        (err = launch_pass<8, kUp>(p.up, tx, tw1, tw2, th, b1, out, partial, hbuf, M, C, Hd,
                                   Cout, stream)) != cudaSuccess ||
        (err = launch_pass<CW, kDown>(p.main, tx, tw1, tw2, th, b1, out, partial, hbuf, M, C,
                                      Hd, Cout, stream)) != cudaSuccess)
      return err;
  } else if ((err = launch_pass<CW, kFused>(p.main, tx, tw1, tw2, th, b1, out, partial, hbuf, M,
                                            C, Hd, Cout, stream)) != cudaSuccess) {
    return err;
  }
  if (p.main.splits == 1) return cudaSuccess;
  const int64_t n = (int64_t)M * Cout;
  const int64_t blocks = (n / 4 + 255) / 256;
  geglu_split_sum_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      partial, static_cast<__nv_bfloat16*>(out), n, p.main.splits);
  return cudaGetLastError();
}

bool takes(int M, int C, int Hd, int Cout) {
  return M > 0 && C > 0 && Hd > 0 && Cout > 0 && C % kKBox == 0 && Hd % kHT == 0 &&
         Cout % 16 == 0;
}

// the plan at these sizes on the current device, worked out once
cudaError_t plan_of(int M, int C, int Hd, int Cout, Plan* p) {
  static sm90::PlanCache<std::array<int, 5>, Plan> cache;
  int dev;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cache.get({dev, M, C, Hd, Cout}, p,
                   [&](Plan* q) { return make_plan(dev, M, C, Hd, Cout, q); });
}

}  // namespace

// The plan the launch at these sizes takes: plan[0..14) = columns a
// consumer, column groups, hidden splits, x resident (1) or streamed (0),
// up ring slots, W2 ring slots, items, blocks of the fused or
// down-projection pass; two passes (1) or fused (0); and the up-projection
// pass's hidden splits, x resident, up ring slots, items, blocks (zeros when
// fused).  Returns a cudaError_t.
extern "C" int unigeo_geglu_ffn_plan(int M, int C, int Hd, int Cout, int* plan) {
  if (!takes(M, C, Hd, Cout) || plan == nullptr) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = plan_of(M, C, Hd, Cout, &p);
  if (err != cudaSuccess) return (int)err;
  const Pass &m = p.main, &u = p.up;
  const int v[kPlanInts] = {m.cw,    m.groups, m.splits,   m.xres,   m.nsu,  m.nsw,
                            m.items, m.blocks, p.two_pass, u.splits, u.xres, u.nsu,
                            u.items, u.blocks};
  for (int i = 0; i < kPlanInts; ++i) plan[i] = v[i];
  return 0;
}

// x [M, C], w1 [2 Hd, C], b1 [2 Hd], w2 [Cout, Hd], out [M, Cout]: all
// contiguous bf16; partial, f32 [splits, M, Cout] of the plan's hidden
// splits, when those are more than one;
// hbuf, bf16 [M, Hd], when the plan takes two passes.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int unigeo_geglu_ffn(const void* x, const void* w1, const void* b1, const void* w2,
                                void* out, float* partial, void* hbuf, int M, int C, int Hd,
                                int Cout, void* stream) {
  const uintptr_t ptrs = (uintptr_t)x | (uintptr_t)w1 | (uintptr_t)w2 | (uintptr_t)hbuf;
  if (!takes(M, C, Hd, Cout) || ptrs % 16 || (uintptr_t)out % 4 || (uintptr_t)partial % 16)
    return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = plan_of(M, C, Hd, Cout, &p);
  if (err != cudaSuccess) return (int)err;
  if ((p.main.splits > 1 && partial == nullptr) || (p.two_pass && hbuf == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p.main.cw) {
    case 320: return (int)launch<320>(p, x, w1, b1, w2, out, partial, hbuf, M, C, Hd, Cout, st);
    case 160: return (int)launch<160>(p, x, w1, b1, w2, out, partial, hbuf, M, C, Hd, Cout, st);
    case 64: return (int)launch<64>(p, x, w1, b1, w2, out, partial, hbuf, M, C, Hd, Cout, st);
    case 32: return (int)launch<32>(p, x, w1, b1, w2, out, partial, hbuf, M, C, Hd, Cout, st);
    default: return (int)launch<8>(p, x, w1, b1, w2, out, partial, hbuf, M, C, Hd, Cout, st);
  }
}
