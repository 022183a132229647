// Grouped GEMM over rows sorted by group (CUDA, sm_90a):
//   y[m, :] = x[m, :] @ w[e]   for offsets[e] <= m < offsets[e + 1],
// x [M, K], w [E, K, N], offsets int32 [E + 1] on the device (offsets[0] =
// 0, nondecreasing, offsets[E] = M), y [M, N] in x's dtype. Sums are fp32
// and y is rounded once, at the end.
//
// Replaces the megablox grouped GEMM that aphrodite_tpu/models/
// moe_common.py calls for a sparse-MoE layer's expert projections
// (`gmm`, jax/experimental/pallas/ops/tpu/megablox/gmm.py:314, its
// pallas_call at :526 and its tile list make_group_metadata at :79).
//
// Bound. At the Qwen1.5-MoE-A2.7B main path's prefill wave (M = 65536 sorted
// rows, E = 60) it is bound by operations: gate|up (K 2048, N 2816) is
// 0.76 TFLOP, 0.76 ms at 989 TFLOP/s, and down (K 1408, N 2048) 0.38 ms; the
// bytes (x, the experts' weights, y) take ~0.40 ms and ~0.24 ms at
// 3.35 TB/s. At M = 240 (the grouped route's threshold) the experts'
// weights bound it: ~0.31 ms for the two. On an H100 the bf16 kernel takes
// ~3.4x the bound at the wave and ~1.35x at M = 240 (PERF.md).
//
// Work items. The rows are cut into tiles of BM rows at multiples of BM. A
// work item is a (group, row tile) pair whose rows overlap: a tile that
// straddles a group boundary is visited once per group, and each visit
// writes only its own group's rows, so every row of y is written exactly
// once, with no atomics, in a fixed order. Empty groups get no item. There
// are at most cdiv(M, BM) + E - 1 items; the grid launches that many
// (known on the host from M and E alone) and each block finds its own item
// from `offsets` on the device (find_item: a warp-wide prefix sum of the
// groups' tile counts), so the host never reads the group sizes. Blocks
// past the last item return at once. No rows are padded.
//
// Two kernels:
// - gmm_bf16_kernel: tensor cores, mma.sync m16n8k16 with fp32
//   accumulators. A block of 8 warps owns a 128 x 128 tile of y (each warp
//   64 x 32); 32-deep slices of x and w are staged in shared memory by
//   cp.async in a ring of 3 (zero-filled past K, N and the item's rows) and
//   read with ldmatrix (w through .trans). Needs K and N multiples of 8
//   (16-byte rows).
// - gmm_f32_kernel: fp32 FMAs on the CUDA cores for the fp32 parity paths,
//   64 x 64 tiles, any K and N.
// Left for later: wgmma with TMA loads and a persistent tile scheduler
// (the warpgroup products are the only way to the card's full bf16 rate;
// mma.sync tops out well below it).
#include "mma_common.cuh"

namespace {

using namespace mma;

enum Dtype { kFloat32 = 0, kBFloat16 = 1 };

constexpr int kThreads = 256;

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

// ------------------------------------------------------------- bf16 kernel
constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
constexpr int kAPitch = kBK + 8;  // bf16 per staged x row: 80 B, so the 8
                                  // rows an ldmatrix reads hit 8 bank groups
constexpr int kBPitch = kBN + 8;  // bf16 per staged w row: 272 B, likewise
constexpr int kAStage = kBM * kAPitch;
constexpr int kBStage = kBK * kBPitch;
constexpr int kSmemBf16 = kStages * (kAStage + kBStage) * 2;  // bytes

__global__ void __launch_bounds__(kThreads)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                const int* __restrict__ offsets,
                __nv_bfloat16* __restrict__ out, int M, int K, int N, int E) {
  int group, row_lo, row_hi;
  if (!find_item<kBM>(offsets, E, M, blockIdx.y, group, row_lo, row_hi))
    return;
  extern __shared__ uint4 smem4[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* b_s = a_s + kStages * kAStage;
  const int m0 = row_lo - row_lo % kBM;  // the tile's first row
  const int n0 = blockIdx.x * kBN;
  const __nv_bfloat16* wg = w + (size_t)group * K * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // warp tile: 64 rows x 32 cols
  const int k_tiles = (K + kBK - 1) / kBK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    __nv_bfloat16* as = a_s + stage * kAStage;
    __nv_bfloat16* bs = b_s + stage * kBStage;
#pragma unroll
    for (int q = 0; q < kBM * (kBK / 8) / kThreads; ++q) {
      const int i = threadIdx.x + q * kThreads;
      const int r = i / (kBK / 8), c = 8 * (i % (kBK / 8));
      const int row = m0 + r, k = k0 + c;
      const bool ok = row >= row_lo && row < row_hi && k < K;
      cp_async16(as + r * kAPitch + c, ok ? x + (size_t)row * K + k : x, ok);
    }
#pragma unroll
    for (int q = 0; q < kBK * (kBN / 8) / kThreads; ++q) {
      const int i = threadIdx.x + q * kThreads;
      const int r = i / (kBN / 8), c = 8 * (i % (kBN / 8));
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < K && n < N;
      cp_async16(bs + r * kBPitch + c, ok ? wg + (size_t)k * N + n : wg, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed
    __syncthreads();               // and slice kt - 1 is consumed
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next);
    cp_async_commit();
    const __nv_bfloat16* as = a_s + (kt % kStages) * kAStage;
    const __nv_bfloat16* bs = b_s + (kt % kStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // A fragments of four 16-row tiles: lane l addresses row l % 16 and
      // k half l / 16 of its tile. B fragments of two 16-column pairs
      // (transposed): lane l addresses k row l % 16, columns 8 (l / 16).
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], as + (wm * 64 + mi * 16 + (lane & 15)) * kAPitch +
                                kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + (lane & 15)) * kBPitch + wn * 32 +
                                 nj * 16 + (lane >> 4) * 8);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();

  // Lane (g, t) holds rows g and g + 8, columns 2t and 2t + 1 of each
  // 16 x 8 tile; only the item's rows are written.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mi * 16 + g + 8 * h;
      if (row < row_lo || row >= row_hi) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * t;
        if (n >= N) continue;  // N % 8 == 0: n + 1 < N too
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + n) =
            __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

// -------------------------------------------------------------- fp32 kernel
constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(kThreads)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ offsets, float* __restrict__ out,
               int M, int K, int N, int E) {
  int group, row_lo, row_hi;
  if (!find_item<kFM>(offsets, E, M, blockIdx.y, group, row_lo, row_hi))
    return;
  __shared__ float a_s[kFK][kFM + 4];  // [k][row]
  __shared__ float b_s[kFK][kFN + 4];  // [k][col]
  const int m0 = row_lo - row_lo % kFM;
  const int n0 = blockIdx.x * kFN;
  const float* wg = w + (size_t)group * K * N;
  // Thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j.
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
    for (int q = 0; q < kFM * kFK / kThreads; ++q) {
      const int i = threadIdx.x + q * kThreads;
      const int r = i / kFK, c = i % kFK;
      const int row = m0 + r, k = k0 + c;
      a_s[c][r] = (row >= row_lo && row < row_hi && k < K)
                      ? __ldg(x + (size_t)row * K + k)
                      : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kFK * kFN / kThreads; ++q) {
      const int i = threadIdx.x + q * kThreads;
      const int r = i / kFN, c = i % kFN;
      const int k = k0 + r, n = n0 + c;
      b_s[r][c] = (k < K && n < N) ? __ldg(wg + (size_t)k * N + n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row < row_lo || row >= row_hi) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(size_t)row * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// Entry point (ctypes). dtype: 0 fp32, 1 bf16 (x, w and out alike);
// offsets int32 [E + 1] on the device. Launches cdiv(M, BM) + E - 1 work
// items on `stream` and returns a cudaError_t (cudaErrorInvalidValue for
// arguments the kernels do not take: bf16 needs K and N multiples of 8).
extern "C" int grouped_matmul_launch(int dtype, const void* x, const void* w,
                                     const int* offsets, void* out, int M,
                                     int K, int N, int E, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || N < 1 || E < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kBFloat16) {
    if (K % 8 != 0 || N % 8 != 0) return (int)cudaErrorInvalidValue;
    const long items = (M + kBM - 1) / kBM + (long)E - 1;
    if (items > 65535) return (int)cudaErrorInvalidValue;
    const cudaError_t err = allow_smem<gmm_bf16_kernel>(kSmemBf16);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + kBN - 1) / kBN, (unsigned)items);
    gmm_bf16_kernel<<<grid, kThreads, kSmemBf16, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), offsets,
        static_cast<__nv_bfloat16*>(out), M, K, N, E);
    return (int)cudaGetLastError();
  }
  if (dtype == kFloat32) {
    const long items = (M + kFM - 1) / kFM + (long)E - 1;
    if (items > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + kFN - 1) / kFN, (unsigned)items);
    gmm_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), offsets,
        static_cast<float*>(out), M, K, N, E);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
