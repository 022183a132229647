// Grouped GEMM over rows sorted by group (CUDA, sm_90a):
//   y[m, :] = x[m, :] @ w[e]   for offsets[e] <= m < offsets[e + 1],
// x [M, K], w [E, K, N], offsets int32 [E + 1] on the device (offsets[0] =
// 0, nondecreasing, offsets[E] = M), y [M, N] in x's dtype. Sums are fp32
// and y is rounded once, at the end: what megablox gmm with
// preferred_element_type=f32 and then .astype(x's dtype) gives.
//
// Replaces the megablox grouped GEMM that aphrodite_tpu/models/
// moe_common.py calls for a sparse-MoE layer's expert projections
// (`gmm`, jax/experimental/pallas/ops/tpu/megablox/gmm.py:314, its
// pallas_call at :526 and its tile list make_group_metadata at :79).
//
// Bound (bf16 and fp16 alike). At the Qwen1.5-MoE-A2.7B main path's
// prefill wave (M = 65536 sorted rows, E = 60) it is bound by operations:
// gate|up (K 2048, N 2816) is 0.76 TFLOP, 0.76 ms at 989 TFLOP/s, and down
// (K 1408, N 2048) 0.38 ms; the
// bytes (x, the experts' weights, y) take ~0.40 ms and ~0.24 ms at
// 3.35 TB/s. At M = 240 (the grouped route's threshold) the experts'
// weights bound it: ~0.30 ms for the two. Only the warpgroup products
// (wgmma) reach the card's bf16 rate, and they want operands in swizzled
// shared memory, fed without the consumers' registers or instructions:
// that is what the wgmma kernel is built around. A 128 x 256 tile reads
// 1.5 MB from L2 for 134 MFLOP at K = 2048, ~11 TB/s at the peak rate,
// above what L2 gives: hence the clusters that share w.
//
// Work items. The rows are cut into tiles of BM rows at multiples of BM. A
// work item is a (group, row tile) pair whose rows overlap: a tile that
// straddles a group boundary is visited once per group, and each visit
// writes only its own group's rows, so every row of y is written exactly
// once, with no atomics, in a fixed order. Empty groups get no item. There
// are at most cdiv(M, BM) + E - 1 items, known on the host from M and E
// alone; each block finds an item from `offsets` on the device (find_item:
// a warp-wide prefix sum of the groups' tile counts), so the host never
// reads the group sizes. Items are numbered in row order, so the first
// item without work ends the list. No rows are padded.
//
// Two kernels:
// - gmm_wgmma_kernel<T> (bf16 or fp16, x's element type T a template
//   parameter: wgmma's f32.bf16.bf16 or f32.f16.f16 form, the tensor maps'
//   element type and the epilogue's rounding; the bf16 instance is built
//   in csrc/grouped_matmul.cu, the fp16 one in csrc/grouped_matmul_f16.cu,
//   a translation unit of its own, so that nvcc compiles them side by
//   side): persistent and warp-specialised, in clusters of two blocks. Cluster c of the grid (as many clusters as fit on the
//   card at once, ~one block an SM) walks the pair tiles u = c, c +
//   clusters, ...: its two blocks take work items 2p and 2p + 1, p = u /
//   n_tiles, at columns (u % n_tiles) * BN, so the tiles in flight at once
//   share x row tiles and one expert's weights in L2. Each block has three
//   warpgroups. Warpgroup 0 gives up registers (setmaxnreg) and one thread
//   of it loads, by TMA, a 128 x 64 slice of x (2D map; rows past M read
//   zeros) and a 64 x 256 slice of the expert's w (3D map over [E, K, N],
//   four 64-wide boxes; K and N past the edge read zeros) into a ring of 3
//   stages of 48 KB, each with a "full" and an "empty" mbarrier. When both
//   items of the pair are of one expert, each block loads two of the four
//   w boxes and multicasts them to both, which cuts the L2 reads of a tile
//   by a third; so each block's consumers release a stage in both blocks.
//   Warpgroups 1 and 2 take registers and each multiplies 64 rows x 256
//   columns with wgmma m64n256k16 (x K-major, w MN-major through the
//   transpose-B immediate, 128-byte swizzle), one group of products in
//   flight; a consumer none of whose rows is the item's releases the
//   stages unread. The ring's position and phases carry over from tile to
//   tile, so the producer loads the next tile while the consumers round
//   this one's fp32 sums to T. A consumer whose 64 rows all belong to
//   the item writes them into a swizzled 32 KB slab of shared memory and
//   sends them out by TMA stores, which overlap the next tile's products
//   (rows past M and columns past N are not written); the rows of a
//   straddling tile go out by masked 4-byte stores. Needs K and N
//   multiples of 8 (TMA's 16-byte strides).
// - gmm_f32_kernel (csrc/grouped_matmul.cu): fp32 FMAs on the CUDA cores
//   for the fp32 parity paths, 64 x 64 tiles, one block an item and column
//   tile, any K and N.
// What holds the wgmma kernel back (timed in bf16; grouped_variants.py
// times it with parts removed): the two consumers round and store each
// tile at the same time, so the tensor cores idle through the epilogue (~6 % at the wave);
// a straddling tile is multiplied once per group (the balanced wave has
// ~11 % more tiles than full ones; skipping a consumer with none of the
// item's rows wins ~4 %); at M = 240 the experts' weights stream at ~90 %
// of the HBM rate.
#pragma once

#include <type_traits>

#include "hopper_common.cuh"
#include "mma_common.cuh"

namespace {

using namespace hopper;
using mma::allow_smem;

// x's dtype codes (the attention kernels' table): fp32 0, bf16 1, fp16 2.
enum Dtype { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };
template <typename T>
constexpr int kCode = std::is_same<T, __half>::value ? kFloat16 : kBFloat16;

// The rows [row_lo, row_hi) and group of work item `item`, or false when
// the item has no work. Every lane of the calling warp takes part and gets
// the same answer. Offsets are clamped to [0, M] so that no row outside y
// is ever touched.
template <int BM>
__device__ __forceinline__ bool find_item(const int* __restrict__ offsets,
                                          int E, int M, int item, int& group,
                                          int& row_lo, int& row_hi) {
  const int lane = threadIdx.x & 31;
  int base = 0;  // items of the groups before this chunk of 32
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    int start = 0, end = 0;
    if (e < E) {
      start = min(max(__ldg(offsets + e), 0), M);
      end = min(max(__ldg(offsets + e + 1), start), M);
    }
    const int tiles = end > start ? (end - 1) / BM - start / BM + 1 : 0;
    int incl = tiles;  // inclusive prefix sum over the chunk's lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    // The first lane whose running count passes `item` owns it (its own
    // count is > 0 there, so it is a non-empty group).
    const unsigned hit = __ballot_sync(0xffffffffu, item < base + incl);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const int before = __shfl_sync(0xffffffffu, incl - tiles, src);
      const int s = __shfl_sync(0xffffffffu, start, src);
      const int en = __shfl_sync(0xffffffffu, end, src);
      const int tile = s / BM + (item - base - before);
      group = e0 + src;
      row_lo = max(tile * BM, s);
      row_hi = min(tile * BM + BM, en);
      return true;
    }
    base += __shfl_sync(0xffffffffu, incl, 31);
  }
  return false;
}

// ---------------------------------------------- wgmma kernel (bf16, fp16)
constexpr int kWgBM = 128, kWgBN = 256, kWgBK = 64, kWgStages = 3;
constexpr int kWgThreads = 384;  // producer warpgroup + 2 consumers
constexpr int kCluster = 2;      // blocks on consecutive items
constexpr int kABytes = kWgBM * kWgBK * 2;  // x: 128 rows of 128 bytes
constexpr int kBBox = kWgBK * 64 * 2;       // w: 64 K rows x 64 N
constexpr int kBBoxes = kWgBN / 64;
constexpr int kStageBytes = kABytes + kBBoxes * kBBox;  // 48 KB
constexpr int kOutBox = 64 * 64 * 2;  // y: 64 rows x 64 columns
constexpr int kOutBytes = kBBoxes * kOutBox;  // a consumer's 64 x 256
constexpr int kSmemWgmma = kWgStages * kStageBytes  // the ring
                           + 2 * kOutBytes          // y on its way out
                           + 2 * kWgStages * 8      // the ring's barriers
                           + 1024;                  // to align the ring
// Every consumer warp of both blocks releases a stage: either block's
// producer may write it (multicast).
constexpr int kEmptyArrivals = kCluster * 8;

// This block's work item in the pair (2 p, 2 p + 1) that its cluster
// takes: the rows it writes (none when `store` is false: the odd last item
// has no partner, and its block multiplies its partner's rows again) and
// whether both blocks multiply the same expert, so that each loads half of
// the w slice for both.
struct PairItem {
  int group, row_lo, row_hi;
  bool store, share;
};

// Every lane of the calling warp takes part; false when item 2 p has no
// work (for both blocks of the cluster alike).
__device__ __forceinline__ bool find_pair(const int* __restrict__ offsets,
                                          int E, int M, int p, uint32_t rank,
                                          PairItem& it) {
  int g0, lo0, hi0, g1, lo1, hi1;
  if (!find_item<kWgBM>(offsets, E, M, 2 * p, g0, lo0, hi0)) return false;
  const bool has1 = find_item<kWgBM>(offsets, E, M, 2 * p + 1, g1, lo1, hi1);
  if (!has1) {
    g1 = g0;
    lo1 = lo0;
    hi1 = hi0;
  }
  it.group = rank ? g1 : g0;
  it.row_lo = rank ? lo1 : lo0;
  it.row_hi = rank ? hi1 : hi0;
  it.store = rank == 0 || has1;
  it.share = g0 == g1;
  return true;
}

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kWgThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ CUtensorMap y_map,
                     const int* __restrict__ offsets, T* __restrict__ out,
                     int M, int K, int N, int E, int n_tiles,
                     long long max_tiles) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: TMA and wgmma agree on
  // it only for tiles that start on such a boundary (at the same offset in
  // both blocks of the cluster, which multicast relies on too).
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* y_smem = smem + kWgStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(y_smem + 2 * kOutBytes);
  uint64_t* empty = full + kWgStages;
  const uint32_t rank = cluster_ctarank();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kEmptyArrivals);
    }
    mbar_fence_init();
  }
  cluster_sync();  // no block loads into or releases the other's ring early
  const int k_tiles = (K + kWgBK - 1) / kWgBK;
  const int lane = threadIdx.x & 31;
  const int cid = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  int stage = 0;
  uint32_t phase = 0;
  int pair = -1;
  PairItem it;

  if (threadIdx.x < 128) {
    // Producer: one warp walks the tiles, its first lane issues the loads.
    regs_dealloc<56>();
    if (threadIdx.x >= 32) return;
    for (long long t = cid; t < max_tiles; t += clusters) {
      const int p = static_cast<int>(t / n_tiles);
      if (p != pair) {
        if (!find_pair(offsets, E, M, p, rank, it)) break;
        pair = p;
      }
      if (lane == 0) {
        const int m0 = it.row_lo - it.row_lo % kWgBM;
        const int n0 = static_cast<int>(t % n_tiles) * kWgBN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);  // free in both blocks
          uint8_t* a = smem + stage * kStageBytes;
          mbar_arrive_expect_tx(&full[stage], kStageBytes);
          tma_load_2d(a, &x_map, &full[stage], kt * kWgBK, m0);
          if (it.share) {  // this block's half of w, for both
#pragma unroll
            for (int j = rank * kBBoxes / 2; j < (rank + 1) * kBBoxes / 2;
                 ++j)
              tma_load_3d_multicast(a + kABytes + j * kBBox, &w_map,
                                    &full[stage], n0 + 64 * j, kt * kWgBK,
                                    it.group, (1 << kCluster) - 1);
          } else {
#pragma unroll
            for (int j = 0; j < kBBoxes; ++j)
              tma_load_3d(a + kABytes + j * kBBox, &w_map, &full[stage],
                          n0 + 64 * j, kt * kWgBK, it.group);
          }
          if (++stage == kWgStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      __syncwarp();
    }
    // Stay until both blocks' consumers have released every stage: they
    // arrive on this block's barriers.
    if (lane == 0) {
      for (int s = 0; s < kWgStages; ++s) {
        mbar_wait(&empty[stage], phase ^ 1);
        if (++stage == kWgStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns rows [64 c, 64 c + 64) of each tile.
    regs_alloc<224>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3;
    float acc[kWgBN / 2];
    for (long long t = cid; t < max_tiles; t += clusters) {
      const int p = static_cast<int>(t / n_tiles);
      if (p != pair) {
        if (!find_pair(offsets, E, M, p, rank, it)) break;
        pair = p;
      }
      const int m0 = it.row_lo - it.row_lo % kWgBM;
      const int n0 = static_cast<int>(t % n_tiles) * kWgBN;
      const int r64 = m0 + 64 * c;
      if (!it.store || it.row_lo >= r64 + 64 || it.row_hi <= r64) {
        // None of this consumer's rows is the item's (a straddling item,
        // the small-M route, the odd last item's partner): release the
        // stages unread and leave the tensor cores to the other consumer.
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&full[stage], phase);
          if (lane < kCluster) mbar_arrive_cluster(&empty[stage], lane);
          if (++stage == kWgStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        continue;
      }
      int prev = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&full[stage], phase);
        __syncwarp();  // the products below are warp-aligned
        const uint8_t* a = smem + stage * kStageBytes + c * (kABytes / 2);
        const uint8_t* b = smem + stage * kStageBytes + kABytes;
        fence_regs<kWgBN / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk)
          wgmma_m64n256k16_tb<T>(acc, wgmma_desc(a + 32 * kk, 16, 1024),
                                 wgmma_desc(b + 2048 * kk, kBBox, 1024),
                                 (kt | kk) != 0);
        wgmma_commit();
        fence_regs<kWgBN / 2>(acc);
        // The products of the previous stage are done: release it.
        wgmma_wait<1>();
        fence_regs<kWgBN / 2>(acc);
        if (kt > 0 && lane < kCluster) mbar_arrive_cluster(&empty[prev], lane);
        prev = stage;
        if (++stage == kWgStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs<kWgBN / 2>(acc);
      if (lane < kCluster) mbar_arrive_cluster(&empty[prev], lane);

      // acc[4 j + 2 h + i]: row 16 warp + lane / 4 + 8 h of this
      // consumer's 64, column 8 j + 2 (lane % 4) + i. Where the item owns
      // all of them, the 64 rows go out through shared memory by TMA
      // stores (rows past M and columns past N are not written), which
      // overlap the next tile's products; else only the item's rows are
      // written, straight from the registers.
      if (it.row_lo <= r64 && r64 < M && min(r64 + 64, M) <= it.row_hi) {
        uint8_t* ys = y_smem + c * kOutBytes;
        const bool leader = threadIdx.x % 128 == 0;
        if (leader) bulk_wait_read<0>();  // the last tile's stores read ys
        named_sync(1 + c, 128);
        // 128-byte swizzle, as the map reads it: row r's 16-byte chunk q
        // of a 64-column box sits at chunk q ^ (r % 8), and r % 8 is
        // lane / 4 here.
        const int g = lane >> 2;
        uint8_t* rowp = ys + (16 * warp + g) * 128 + 4 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < kWgBN / 8; ++j)
            *reinterpret_cast<uint32_t*>(rowp + h * 8 * 128 +
                                         (j / 8) * kOutBox +
                                         ((j % 8) ^ g) * 16) =
                mma::pack<T>(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        fence_proxy_async();
        named_sync(1 + c, 128);
        if (leader) {
#pragma unroll
          for (int j = 0; j < kBBoxes; ++j)
            tma_store_2d(&y_map, ys + j * kOutBox, n0 + 64 * j, r64);
          bulk_commit();
        }
        continue;
      }
      const int r0 = r64 + 16 * warp + (lane >> 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row < it.row_lo || row >= it.row_hi) continue;
        T* orow = out + (size_t)row * N;
#pragma unroll
        for (int j = 0; j < kWgBN / 8; ++j) {
          const int n = n0 + 8 * j + 2 * (lane & 3);
          if (n < N)  // N % 8 == 0: n + 1 < N too
            *reinterpret_cast<uint32_t*>(orow + n) = mma::pack<T>(
                acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
    if (threadIdx.x % 128 == 0) bulk_wait<0>();  // before ys goes away
  }
}

// Launch gmm_wgmma_kernel<T> for x, w and out of T (dtype: the caller's
// code, which must be T's): min(grid, tiles) persistent blocks in clusters
// of two (grid: the card's SM count) on `stream`. Returns a cudaError_t
// (cudaErrorInvalidValue for arguments the kernel does not take: K and N
// multiples of 8 and 16-byte aligned x and w).
template <typename T>
int launch_wgmma(int dtype, const void* x, const void* w, const int* offsets,
                 void* out, int M, int K, int N, int E, int grid,
                 cudaStream_t s) {
  if (dtype != kCode<T> || M < 1 || K < 1 || N < 1 || E < 1 || K % 8 != 0 ||
      N % 8 != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap x_map, w_map;
  const uint64_t x_dims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t x_strides[1] = {(uint64_t)K * 2};
  const uint32_t x_box[2] = {kWgBK, kWgBM};
  cudaError_t err =
      make_tma_map_16<T>(&x_map, x, 2, x_dims, x_strides, x_box);
  if (err != cudaSuccess) return (int)err;
  const uint64_t w_dims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
  const uint64_t w_strides[2] = {(uint64_t)N * 2, (uint64_t)K * N * 2};
  const uint32_t w_box[3] = {64, kWgBK, 1};
  err = make_tma_map_16<T>(&w_map, w, 3, w_dims, w_strides, w_box);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap y_map;
  const uint64_t y_dims[2] = {(uint64_t)N, (uint64_t)M};
  const uint64_t y_strides[1] = {(uint64_t)N * 2};
  const uint32_t y_box[2] = {64, 64};
  err = make_tma_map_16<T>(&y_map, out, 2, y_dims, y_strides, y_box);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem<gmm_wgmma_kernel<T>>(kSmemWgmma);
  if (err != cudaSuccess) return (int)err;
  static int fit = 0;  // clusters the card holds at once, asked once
  if (fit == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster * (grid > kCluster ? grid / kCluster : 1));
    cfg.blockDim = dim3(kWgThreads);
    cfg.dynamicSmemBytes = kSmemWgmma;
    err = cudaOccupancyMaxActiveClusters(&fit, gmm_wgmma_kernel<T>, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const int n_tiles = (N + kWgBN - 1) / kWgBN;
  const long long items = (M + kWgBM - 1) / kWgBM + (long long)E - 1;
  const long long max_tiles = (items + 1) / 2 * n_tiles;  // of pairs
  long long clusters = grid / kCluster < fit ? grid / kCluster : fit;
  if (clusters > max_tiles) clusters = max_tiles;
  if (clusters < 1) clusters = 1;
  gmm_wgmma_kernel<T><<<(unsigned)(kCluster * clusters), kWgThreads,
                        kSmemWgmma, s>>>(x_map, w_map, y_map, offsets,
                                         static_cast<T*>(out), M, K, N, E,
                                         n_tiles, max_tiles);
  return (int)cudaGetLastError();
}

}  // namespace
