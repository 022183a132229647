// Weight-only quantized GEMMs in fp32, y[M, N] = x[M, K] @ W (CUDA,
// sm_90a), on the CUDA cores.
//
// Replace, for fp32 activations, the TPU kernels of
// aphrodite_tpu/ops/quant_matmul_pallas.py:
//   w8a16_launch         <- w8a16_matmul_pallas / _w8_kernel:
//                           W = q[k, n] * s[n], q int8 [K, N], s fp32 [N]
//   w4a16_launch         <- w4a16_matmul_pallas / _w4_kernel:
//                           W = (q[k, n] - z[g, n]) * s[g, n], g = k / group,
//                           q uint4 held in int8 [K, N], s, z fp32 [G, N]
//   w4a16_packed_launch  <- w4a16_packed_matmul_pallas / _w4p_kernel: the
//                           same W from uint8 [K/2, N], byte [r, n] holding
//                           row r in bits 0-3 and row r + K/2 in bits 4-7
//                           (so the high nibble's group is (r + K/2) / group)
//   w4a16_int4_launch    <- w4a16_int4_matmul_pallas / _w4i4_kernel: signed
//                           int4 from uint8 [K/2, N], group-wise form (see
//                           the note above q4_kernel)
//   fp8_launch           <- no Pallas kernel (XLA computes fp8_matmul,
//                           aphrodite_tpu/ops/quant_gemm.py:74-119): W =
//                           q[k, n] * s[n], q e4m3fn [K, N], s fp32 [N]; an
//                           optional fp32 scale a row of x, rs [M], makes
//                           the W8A8 epilogue (acc * rs[m]) * s[n], in
//                           the reference's order
// bf16 activations of every layout run on w4_wgmma.cu (wgmma, the
// group-wise form). Here x, y and the sums are fp32. W is dequantized in
// registers and never written to device memory. qmm_kernel takes the
// direct form (q - z) * s; W8 and fp8 apply s[n] to the fp32 sum (an e4m3
// byte converts exactly by the hardware's cvt to f16, then to fp32).
//
// Bound. fp32 FMAs on the CUDA cores (2 M K N of them), bound by
// operations at M = 32: ~0.045 ms a Qwen2.5-1.5B layer's four GEMMs at 67
// TFLOP/s. tf32 would not hold fp32's tolerance.
//
// Design of qmm_kernel. A block of 4 warps owns 128 output columns (4 per
// lane, one 32-bit load per weight row) and up to 32 rows of M (template
// MT; more rows take more blocks along z). A chunk of stored rows (grid y)
// is walked in tiles of 128 rows: the block stages the tile's x columns in
// shared memory as fp32 (transposed, so one float4 read serves 4 rows of
// M), each warp takes 32 of the tile's rows, loading 8 rows of weights
// before it uses them, and the warps' sums meet in shared memory.
//
// Both kernels cut the stored weight rows into `splits` chunks along K
// (grid y) when the columns alone give the card too few blocks (4096
// columns are 32 blocks): each block then writes fp32 partial sums, and
// the last block of a tile to finish adds them in split order
// (deterministic) and writes y (finish_splits).
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "mma_common.cuh"

namespace {

using mma::allow_smem;

enum Layout { kW8 = 0, kW4 = 1, kW4Packed = 2, kFp8 = 3 };

// One fp32 scale a column applied to the sum (no groups, no zeros).
__host__ __device__ constexpr bool col_scaled(int layout) {
  return layout == kW8 || layout == kFp8;
}
enum Dtype { kFloat32 = 0 };

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;                        // columns per lane
constexpr int kBlockN = 32 * kCols;             // columns per block
constexpr int kTileK = 128;                     // stored rows per x tile
constexpr int kRowsPerWarp = kTileK / kWarps;   // 32
constexpr int kUnroll = 8;                      // weight rows in flight

__device__ __forceinline__ float to_float(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

// Shared memory of one block, in floats: the staged x tile
// [kTileK * halves][MT + 4] or the warps' sums [kWarps - 1][MT][kBlockN].
__host__ __device__ constexpr int smem_floats(int mt, int halves) {
  return kTileK * halves * (mt + 4) > (kWarps - 1) * mt * kBlockN
             ? kTileK * halves * (mt + 4)
             : (kWarps - 1) * mt * kBlockN;
}

// Split-K fixup, called by every thread of a block that wrote its fp32
// partial sums [split, M, N] for rows [m0, m0 + mt) and columns [col0,
// col0 + bn): the last block of the (column tile, M tile) to finish adds
// the splits' sums in split order (deterministic), applies W8's s[n],
// writes y, and resets the tile's counter for the next launch. row_scales:
// fp8's scale a row of x (or null), applied before s[n].
template <typename T, int L>
__device__ void finish_splits(const float* partial, int* counters,
                              const float* scales, const float* row_scales,
                              T* out, int M, int N, int m0, int mt, int col0,
                              int bn) {
  __shared__ int is_last;
  __threadfence();  // this block's partial sums are visible device-wide
  __syncthreads();
  int* counter = counters + blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0)
    is_last = atomicAdd(counter, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int rows = min(mt, M - m0), quads = min(bn, N - col0) / 4;
  for (int i = threadIdx.x; i < rows * quads; i += blockDim.x) {
    const int m = m0 + i / quads, n = col0 + 4 * (i % quads);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < (int)gridDim.y; ++sp) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(
          partial + ((size_t)sp * M + m) * N + n));
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    if (col_scaled(L)) {
      if (L == kFp8 && row_scales != nullptr) {
        const float r = row_scales[m];
        v.x *= r;
        v.y *= r;
        v.z *= r;
        v.w *= r;
      }
      const float4 sc = __ldg(reinterpret_cast<const float4*>(scales + n));
      v.x *= sc.x;
      v.y *= sc.y;
      v.z *= sc.z;
      v.w *= sc.w;
    }
    T* o = out + (size_t)m * N + n;
    o[0] = from_float<T>(v.x);
    o[1] = from_float<T>(v.y);
    o[2] = from_float<T>(v.z);
    o[3] = from_float<T>(v.w);
  }
  if (threadIdx.x == 0) *counter = 0;
}

template <typename T, int MT, int L>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const T* __restrict__ x, const uint32_t* __restrict__ w,
           const float* __restrict__ scales, const float* __restrict__ zeros,
           T* __restrict__ out, float* __restrict__ partial,
           int* __restrict__ counters, int M, int K, int N, int group,
           int chunk) {
  constexpr int halves = (L == kW4Packed) ? 2 : 1;
  constexpr int XP = MT + 4;  // row pitch of the transposed x tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kBlockN + lane * kCols;
  const bool col_ok = n0 < N;  // N % 4 == 0, so a lane has all 4 or none
  const int m0 = blockIdx.z * MT;
  const int Ks = (L == kW4Packed) ? K / 2 : K;  // stored weight rows
  const int r_begin = blockIdx.y * chunk;
  const int r_end = min(Ks, r_begin + chunk);
  const size_t words = (size_t)N / 4;  // 32-bit words per weight row

  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;
  int g_lo = -1, g_hi = -1;
  float4 s_lo = {}, z_lo = {}, s_hi = {}, z_hi = {};

  for (int t0 = r_begin; t0 < r_end; t0 += kTileK) {
    __syncthreads();  // the previous tile is consumed
    // x_s[(h * kTileK + j) * XP + m] = x[m0 + m, t0 + j + h * Ks]
    for (int i = threadIdx.x; i < MT * kTileK * halves; i += kThreads) {
      const int m = i / (kTileK * halves);
      const int hj = i - m * (kTileK * halves);
      const int h = hj / kTileK, j = hj - h * kTileK;
      float v = 0.f;
      if (m0 + m < M && t0 + j < r_end)
        v = to_float(x[(size_t)(m0 + m) * K + t0 + j + h * Ks]);
      smem[hj * XP + m] = v;
    }
    __syncthreads();
    if (!col_ok) continue;
    const int rw = t0 + warp * kRowsPerWarp;
#pragma unroll 1
    for (int u0 = 0; u0 < kRowsPerWarp; u0 += kUnroll) {
      uint32_t wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = rw + u0 + u;
        wv[u] = r < r_end ? __ldg(w + (size_t)r * words + n0 / 4) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = rw + u0 + u;
        if (r >= r_end) continue;
        const int j = r - t0;
        float wl[kCols], wh[kCols];
        if (L == kW8) {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            wl[c] = (float)(int8_t)((wv[u] >> (8 * c)) & 0xFFu);
        } else if (L == kFp8) {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            wl[c] = __half2float(__half(__nv_cvt_fp8_to_halfraw(
                (__nv_fp8_storage_t)((wv[u] >> (8 * c)) & 0xFFu), __NV_E4M3)));
        } else {
          const int g = r / group;
          if (g != g_lo) {
            g_lo = g;
            s_lo = __ldg(reinterpret_cast<const float4*>(
                scales + (size_t)g * N + n0));
            z_lo = __ldg(reinterpret_cast<const float4*>(
                zeros + (size_t)g * N + n0));
          }
          const float sl[4] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w};
          const float zl[4] = {z_lo.x, z_lo.y, z_lo.z, z_lo.w};
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            wl[c] = ((float)((wv[u] >> (8 * c)) & 0xFu) - zl[c]) * sl[c];
          if (L == kW4Packed) {
            const int gh = (r + Ks) / group;
            if (gh != g_hi) {
              g_hi = gh;
              s_hi = __ldg(reinterpret_cast<const float4*>(
                  scales + (size_t)gh * N + n0));
              z_hi = __ldg(reinterpret_cast<const float4*>(
                  zeros + (size_t)gh * N + n0));
            }
            const float sh[4] = {s_hi.x, s_hi.y, s_hi.z, s_hi.w};
            const float zh[4] = {z_hi.x, z_hi.y, z_hi.z, z_hi.w};
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              wh[c] = ((float)((wv[u] >> (8 * c + 4)) & 0xFu) - zh[c]) *
                      sh[c];
          }
        }
        const float* xl = smem + j * XP;
#pragma unroll
        for (int m = 0; m < MT; m += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xl + m);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[m][c] = fmaf(xv.x, wl[c], acc[m][c]);
            acc[m + 1][c] = fmaf(xv.y, wl[c], acc[m + 1][c]);
            acc[m + 2][c] = fmaf(xv.z, wl[c], acc[m + 2][c]);
            acc[m + 3][c] = fmaf(xv.w, wl[c], acc[m + 3][c]);
          }
        }
        if (L == kW4Packed) {
          const float* xh = smem + (kTileK + j) * XP;
#pragma unroll
          for (int m = 0; m < MT; m += 4) {
            const float4 xv = *reinterpret_cast<const float4*>(xh + m);
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              acc[m][c] = fmaf(xv.x, wh[c], acc[m][c]);
              acc[m + 1][c] = fmaf(xv.y, wh[c], acc[m + 1][c]);
              acc[m + 2][c] = fmaf(xv.z, wh[c], acc[m + 2][c]);
              acc[m + 3][c] = fmaf(xv.w, wh[c], acc[m + 3][c]);
            }
          }
        }
      }
    }
  }

  // Sum the four warps' partial sums of the block's columns.
  __syncthreads();
  float* red = smem;  // [kWarps - 1][MT][kBlockN]
  if (warp > 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
      *reinterpret_cast<float4*>(
          red + ((size_t)(warp - 1) * MT + m) * kBlockN + lane * kCols) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();
  if (warp == 0 && col_ok) {
    float4 sn = make_float4(1.f, 1.f, 1.f, 1.f);
    if (col_scaled(L) && partial == nullptr)
      sn = __ldg(reinterpret_cast<const float4*>(scales + n0));
    // fp8's W8A8 scale of x's rows rides in `zeros` (null: weight-only).
    const float* rs = L == kFp8 ? zeros : nullptr;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c] = acc[m][c];
      for (int wi = 0; wi < kWarps - 1; ++wi) {
        const float4 o = *reinterpret_cast<const float4*>(
            red + ((size_t)wi * MT + m) * kBlockN + lane * kCols);
        v[0] += o.x;
        v[1] += o.y;
        v[2] += o.z;
        v[3] += o.w;
      }
      if (m0 + m >= M) continue;
      if (partial != nullptr) {
        *reinterpret_cast<float4*>(
            partial + ((size_t)blockIdx.y * M + m0 + m) * N + n0) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
        if (rs != nullptr) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) v[c] *= rs[m0 + m];
        }
        T* o = out + (size_t)(m0 + m) * N + n0;
        o[0] = from_float<T>(v[0] * sn.x);
        o[1] = from_float<T>(v[1] * sn.y);
        o[2] = from_float<T>(v[2] * sn.z);
        o[3] = from_float<T>(v[3] * sn.w);
      }
    }
  }
  if (partial != nullptr)
    finish_splits<T, L>(partial, counters, scales,
                        L == kFp8 ? zeros : nullptr, out, M, N, m0, MT,
                        blockIdx.x * kBlockN, kBlockN);
}

template <typename T, int MT, int L>
int launch_mt(const void* x, const void* w, const float* scales,
              const float* zeros, void* out, float* partial, int* counters,
              int M, int K, int N, int group, int splits, int chunk,
              cudaStream_t stream) {
  const int smem = smem_floats(MT, L == kW4Packed ? 2 : 1) * sizeof(float);
  cudaError_t err = allow_smem<qmm_kernel<T, MT, L>>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kBlockN - 1) / kBlockN, splits, (M + MT - 1) / MT);
  qmm_kernel<T, MT, L><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(w), scales,
      zeros, static_cast<T*>(out), splits > 1 ? partial : nullptr, counters,
      M, K, N, group, chunk);
  return (int)cudaGetLastError();
}

template <typename T, int L>
int launch_t(int mt, const void* x, const void* w, const float* scales,
             const float* zeros, void* out, float* partial, int* counters,
             int M, int K, int N, int group, int splits, int chunk,
             cudaStream_t stream) {
  switch (mt) {
    case 8:
      return launch_mt<T, 8, L>(x, w, scales, zeros, out, partial, counters,
                                M, K, N, group, splits, chunk, stream);
    case 16:
      return launch_mt<T, 16, L>(x, w, scales, zeros, out, partial, counters,
                                 M, K, N, group, splits, chunk, stream);
    case 32:
      return launch_mt<T, 32, L>(x, w, scales, zeros, out, partial, counters,
                                 M, K, N, group, splits, chunk, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int L>
int launch(int dtype, int mt, const void* x, const void* w,
           const float* scales, const float* zeros, void* out,
           float* partial, int* counters, int M, int K, int N, int group,
           int splits, int chunk, void* stream) {
  if (N % 4 != 0 || M < 1 || splits < 1 ||
      (splits > 1 && (partial == nullptr || counters == nullptr)) ||
      (!col_scaled(L) && (group < 1 || K % group != 0)) ||
      dtype != kFloat32 ||
      chunk % kTileK != 0)
    return (int)cudaErrorInvalidValue;
  return launch_t<float, L>(mt, x, w, scales, zeros, out, partial, counters,
                            M, K, N, group, splits, chunk,
                            static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// Native-int4 W4A16 in fp32 (w4a16_int4_launch) <- w4a16_int4_matmul_pallas /
// _w4i4_kernel. q4 [K, N] is signed int4 (q - 8), stored as uint8 [K/2, N]
// with rows 2r and 2r + 1 in the low and high nibble of byte [r, n] (two's
// complement); the zeros hold z - 8. The TPU kernel's group-wise form: for
// each segment of a group (the group, or the 256-row x tile when a group
// is longer) the block takes d = x_seg @ q4_seg in fp32 and folds
// (d - sum(x_seg) z) s into its running sum, so s and z touch the
// segment's [MT, N] result once instead of every weight. K splits fall on
// segment boundaries. (bf16 runs on w4_wgmma.cu.)
//
// q4_kernel: one column a thread and up to 32 rows of M, fp32 FMAs on the
// CUDA cores (operations bind: 2 M K N FMAs); the x tile and its
// per-(row, segment) sums in shared memory.
constexpr int kI4TileK = 256;  // rows of K staged at a time

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// xsum[sg][m] = sum of the staged x row m over segment sg of the tile, in
// fp32 (a warp a (segment, row) pair). x_at(m, k) reads the staged tile.
template <int MT, typename XAt>
__device__ __forceinline__ void segment_sums(float* xsum, int nseg, int seg,
                                             XAt x_at) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < nseg * MT; p += kWarps) {
    const int sg = p / MT, m = p - sg * MT;
    float v = 0.f;
    for (int k = lane; k < seg; k += 32) v += x_at(m, sg * seg + k);
    v = warp_sum(v);
    if (lane == 0) xsum[sg * MT + m] = v;
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
q4_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
          const float* __restrict__ scales, const float* __restrict__ zeros,
          float* __restrict__ out, float* __restrict__ partial,
          int* __restrict__ counters, int M, int K, int N, int group,
          int chunk) {
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // [MT][kI4TileK]
  float* xsum = x_s + MT * kI4TileK;             // [nseg][MT]
  const int seg = min(group, kI4TileK);
  const int n = blockIdx.z * kThreads + threadIdx.x;
  const bool ok = n < N;
  const int m0 = blockIdx.x * MT;
  const int k_begin = blockIdx.y * chunk;
  const int k_end = min(K, k_begin + chunk);
  float acc[MT], d[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = d[m] = 0.f;

  for (int t0 = k_begin; t0 < k_end; t0 += kI4TileK) {
    const int t1 = min(k_end, t0 + kI4TileK);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < MT * kI4TileK; i += kThreads) {
      const int m = i / kI4TileK, k = i - m * kI4TileK;
      x_s[i] = (m0 + m < M && t0 + k < t1)
                   ? __ldg(x + (size_t)(m0 + m) * K + t0 + k)
                   : 0.f;
    }
    __syncthreads();
    segment_sums<MT>(xsum, (t1 - t0) / seg, seg,
                     [&](int m, int k) { return x_s[m * kI4TileK + k]; });
    __syncthreads();
    if (!ok) continue;
#pragma unroll 4
    for (int k = t0; k < t1; k += 2) {
      const uint32_t b = __ldg(w + (size_t)(k / 2) * N + n) ^ 0x88u;
      const float q0 = (float)((int)(b & 0xFu) - 8);
      const float q1 = (float)((int)(b >> 4) - 8);
      const float* xk = x_s + (k - t0);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float2 xv = *reinterpret_cast<const float2*>(xk + m * kI4TileK);
        d[m] = fmaf(xv.y, q1, fmaf(xv.x, q0, d[m]));
      }
      if ((k + 2 - t0) % seg != 0) continue;
      const int gi = (k + 2 - seg) / group;
      const int sg = (k + 2 - t0) / seg - 1;
      const float s = __ldg(scales + (size_t)gi * N + n);
      const float z = __ldg(zeros + (size_t)gi * N + n);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        acc[m] += (d[m] - xsum[sg * MT + m] * z) * s;
        d[m] = 0.f;
      }
    }
  }
  if (ok) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m0 + m >= M) break;
      if (partial != nullptr)
        partial[((size_t)blockIdx.y * M + m0 + m) * N + n] = acc[m];
      else
        out[(size_t)(m0 + m) * N + n] = acc[m];
    }
  }
  if (partial != nullptr)
    finish_splits<float, kW4>(partial, counters, scales, nullptr, out, M, N,
                              m0, MT, blockIdx.z * kThreads, kThreads);
}

template <int MT>
int launch_q4(const void* x, const void* w, const float* scales,
              const float* zeros, void* out, float* partial, int* counters,
              int M, int K, int N, int group, int splits, int chunk,
              cudaStream_t stream) {
  const int nseg = kI4TileK / min(group, kI4TileK);
  const int smem = (MT * kI4TileK + nseg * MT) * (int)sizeof(float);
  cudaError_t err = allow_smem<q4_kernel<MT>>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + MT - 1) / MT, splits, (N + kThreads - 1) / kThreads);
  q4_kernel<MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(w), scales,
      zeros, static_cast<float*>(out), splits > 1 ? partial : nullptr,
      counters, M, K, N, group, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Entry points (ctypes). dtype: 0 (fp32; bf16 runs on w4_wgmma.cu); mt:
// rows of M per block (8, 16 or 32); out [M, N] fp32. With splits > 1,
// partial is fp32 [splits, M, N] scratch and counters one int per (column
// tile, M tile), zero before the launch and zero after it; with splits ==
// 1 both may be null. chunk: stored weight rows per split (a multiple of
// 128). Return a cudaError_t.
extern "C" int w8a16_launch(int dtype, int mt, const void* x, const void* q,
                            const float* scales, void* out, float* partial,
                            int* counters, int M, int K, int N, int splits,
                            int chunk, void* stream) {
  return launch<kW8>(dtype, mt, x, q, scales, nullptr, out, partial,
                     counters, M, K, N, 1, splits, chunk, stream);
}

// fp8: q e4m3fn [K, N], scales [N]; row_scales [M] (W8A8: x's scale a row,
// applied before s[n]) or null.
extern "C" int fp8_launch(int dtype, int mt, const void* x, const void* q,
                          const float* scales, const float* row_scales,
                          void* out, float* partial, int* counters, int M,
                          int K, int N, int splits, int chunk, void* stream) {
  return launch<kFp8>(dtype, mt, x, q, scales, row_scales, out, partial,
                      counters, M, K, N, 1, splits, chunk, stream);
}

extern "C" int w4a16_launch(int dtype, int mt, const void* x, const void* q,
                            const float* scales, const float* zeros,
                            void* out, float* partial, int* counters, int M,
                            int K, int N, int group, int splits, int chunk,
                            void* stream) {
  return launch<kW4>(dtype, mt, x, q, scales, zeros, out, partial, counters,
                     M, K, N, group, splits, chunk, stream);
}

extern "C" int w4a16_packed_launch(int dtype, int mt, const void* x,
                                   const void* qpacked, const float* scales,
                                   const float* zeros, void* out,
                                   float* partial, int* counters, int M,
                                   int K, int N, int group, int splits,
                                   int chunk, void* stream) {
  return launch<kW4Packed>(dtype, mt, x, qpacked, scales, zeros, out,
                           partial, counters, M, K, N, group, splits, chunk,
                           stream);
}

// q4 is uint8 [K/2, N] (rows 2r, 2r + 1 in the low and high nibble of byte
// [r, n], signed int4), scales and zeros fp32 [K/group, N]; x and out fp32
// (dtype 0; bf16 runs on w4_wgmma.cu). mt: rows of M per block (8, 16 or
// 32); an even group that divides 256 or is a multiple of it; chunk is a
// multiple of 256 and of the group. partial, counters, splits as for the
// launches above.
extern "C" int w4a16_int4_launch(int dtype, int mt, const void* x,
                                 const void* q4, const float* scales,
                                 const float* zeros, void* out,
                                 float* partial, int* counters, int M, int K,
                                 int N, int group, int splits, int chunk,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (N % 4 != 0 || M < 1 || splits < 1 || group < 2 || group % 2 != 0 ||
      K % group != 0 ||
      (kI4TileK % group != 0 && group % kI4TileK != 0) ||
      chunk % kI4TileK != 0 || chunk % group != 0 ||
      (splits > 1 && (partial == nullptr || counters == nullptr)) ||
      dtype != kFloat32)
    return (int)cudaErrorInvalidValue;
  switch (mt) {
    case 8:
      return launch_q4<8>(x, q4, scales, zeros, out, partial, counters, M, K,
                          N, group, splits, chunk, s);
    case 16:
      return launch_q4<16>(x, q4, scales, zeros, out, partial, counters, M,
                           K, N, group, splits, chunk, s);
    case 32:
      return launch_q4<32>(x, q4, scales, zeros, out, partial, counters, M,
                           K, N, group, splits, chunk, s);
  }
  return (int)cudaErrorInvalidValue;
}
