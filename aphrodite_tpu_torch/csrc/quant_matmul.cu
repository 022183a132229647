// Weight-only quantized GEMMs, y[M, N] = x[M, K] @ W (CUDA, sm_90a).
//
// Replace the TPU kernels of aphrodite_tpu/ops/quant_matmul_pallas.py:
//   w8a16_launch         <- w8a16_matmul_pallas / _w8_kernel:
//                           W = q[k, n] * s[n], q int8 [K, N], s fp32 [N]
//   w4a16_launch         <- w4a16_matmul_pallas / _w4_kernel:
//                           W = (q[k, n] - z[g, n]) * s[g, n], g = k / group,
//                           q uint4 held in int8 [K, N], s, z fp32 [G, N]
//   w4a16_packed_launch  <- w4a16_packed_matmul_pallas / _w4p_kernel: the
//                           same W from uint8 [K/2, N], byte [r, n] holding
//                           row r in bits 0-3 and row r + K/2 in bits 4-7
//                           (so the high nibble's group is (r + K/2) / group)
// x and y are fp32 or bf16 (dtype code 0 / 1); sums are fp32. W is
// dequantized in registers and never written to device memory. The W4
// kernels use the direct form (q - z) * s in fp32, not the TPU kernel's
// x @ (q * s) - xsum @ (z * s), which in bf16 rounds q * s and then
// subtracts a large correction term. W8 applies s[n] to the fp32 sum.
//
// Bound. At decode (M <= 256) the work is the weight stream: at the 8B
// main path's M = 32 the four GEMMs of a layer move ~127 MB (packed bytes
// plus fp32 scales and zeros), ~38 us at 3.35 TB/s. Two kernels:
// - qmm_tc_kernel (bf16 x, K and group multiples of 32): the tensor-core
//   path described above the kernel. Dequantizing (~4 instructions a
//   weight) is what bounds it, not the bytes: ~0.26 ms for a layer's four
//   GEMMs on an H100, ~7x the byte bound (PERF.md).
// - qmm_kernel (fp32 x): fp32 FMAs on the CUDA cores (2 M K N of them),
//   bound by operations at M = 32. tf32 would not hold fp32's tolerance.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Layout { kW8 = 0, kW4 = 1, kW4Packed = 2 };
enum Dtype { kFloat32 = 0, kBFloat16 = 1 };

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;                        // columns per lane
constexpr int kBlockN = 32 * kCols;             // columns per block
constexpr int kTileK = 128;                     // stored rows per x tile
constexpr int kRowsPerWarp = kTileK / kWarps;   // 32
constexpr int kUnroll = 8;                      // weight rows in flight

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared memory of one block, in floats: the staged x tile
// [kTileK * halves][MT + 4] or the warps' sums [kWarps - 1][MT][kBlockN].
__host__ __device__ constexpr int smem_floats(int mt, int halves) {
  return kTileK * halves * (mt + 4) > (kWarps - 1) * mt * kBlockN
             ? kTileK * halves * (mt + 4)
             : (kWarps - 1) * mt * kBlockN;
}

// Raise a kernel's dynamic shared memory limit to `bytes`, calling the
// runtime only when the limit grows (the call costs host time per launch).
// The default limit leaves no room for static shared memory beside 48 KB
// of dynamic, so the first launch always sets it.
template <auto kKernel>
cudaError_t allow_smem(int bytes) {
  static int allowed = 0;  // one per kernel
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// Split-K fixup, called by every thread of a block that wrote its fp32
// partial sums [split, M, N] for rows [m0, m0 + mt) and columns [col0,
// col0 + bn): the last block of the (column tile, M tile) to finish adds
// the splits' sums in split order (deterministic), applies W8's s[n],
// writes y, and resets the tile's counter for the next launch.
template <typename T, int L>
__device__ void finish_splits(const float* partial, int* counters,
                              const float* scales, T* out, int M, int N,
                              int m0, int mt, int col0, int bn) {
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
    if (L == kW8) {
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
    if (L == kW8 && partial == nullptr)
      sn = __ldg(reinterpret_cast<const float4*>(scales + n0));
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
        T* o = out + (size_t)(m0 + m) * N + n0;
        o[0] = from_float<T>(v[0] * sn.x);
        o[1] = from_float<T>(v[1] * sn.y);
        o[2] = from_float<T>(v[2] * sn.z);
        o[3] = from_float<T>(v[3] * sn.w);
      }
    }
  }
  if (partial != nullptr)
    finish_splits<T, L>(partial, counters, scales, out, M, N, m0, MT,
                        blockIdx.x * kBlockN, kBlockN);
}

// ---------------------------------------------------------------------------
// bf16 path on the tensor cores (mma.sync m16n8k16, fp32 accumulation).
//
// The product is taken transposed, y^T[n, m] = W^T[n, k] x^T[k, m], so that
// the dequantized weights are the A operand (16 columns of N per mma) and
// x the B operand (8 rows of M per mma). A block of 2 x 2 warps owns 128
// columns: each warp 64 of them and half of every 256-row x tile, walked
// 32 rows at a time (the next 32 rows' weights load while these are used);
// the two K halves meet in shared memory at the end. The tile's scales and
// zeros (2^23 + z) are staged in shared memory beside x. Within a 16-row step
// the k order is permuted, the same way for W and for x, so that lane
// (g, t) can take its A fragment from whole 32-bit weight words: it loads
// rows t, t + 4, t + 8, t + 12 of the step, words g and g + 8 of the
// warp's 16 (coalesced in 32-byte sectors), and fragment column k = 2t,
// 2t + 1, 2t + 8, 2t + 9 stands for stored row t, t + 4, t + 8, t + 12.
// The x tile is staged in shared memory in that permuted order, so a B
// fragment register is one 32-bit shared load. Fragment row n = g (g + 8)
// of subtile 2c + h stands for column 4 (g + 8 c) + 2 h (+ 1), so a lane's
// two outputs of one row of M are adjacent columns. A weight is
// dequantized in fp32 as (q - z) * s, with q made exact by the
// 2^23 magic-number trick (no integer-to-float conversion), and rounded to
// bf16 for the mma; W8's s[n] multiplies the fp32 sum at the end.
constexpr int kTcWarpN = 64;                    // columns per warp
constexpr int kTcWarpsN = 2;                    // warps side by side on N
constexpr int kTcWarpsK = kWarps / kTcWarpsN;   // warps splitting a tile's K
constexpr int kTcBlockN = kTcWarpsN * kTcWarpN; // columns per block
constexpr int kTcTileK = 256;                   // stored rows per x tile
constexpr int kTcSteps = 2;                     // 16-row steps per unit
constexpr int kTcUnit = 16 * kTcSteps;          // rows loaded at a time
static_assert(kTcWarpsK == 2, "the epilogue adds exactly two K halves");

__device__ __forceinline__ float magic_float(uint32_t v) {
  return __uint_as_float(0x4B000000u | v);      // 2^23 + v, exact
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The weight at bit `shift` of `word`, dequantized. For W4 zf = 2^23 + z,
// so magic - zf = q - z exactly; W8 returns the signed byte q itself.
template <int L>
__device__ __forceinline__ float dequant(uint32_t word, int shift, float s,
                                         float zf) {
  if (L == kW8)  // signed byte: flip the sign bit, then remove the offset
    return magic_float(((word >> shift) & 0xFFu) ^ 0x80u) - 8388736.f;
  return (magic_float((word >> shift) & 0xFu) - zf) * s;
}

// Groups of scales/zeros a tile of kTcTileK rows (starting on a multiple
// of kTcUnit <= group) can touch, per half.
__host__ __device__ constexpr int tc_tile_groups(int group) {
  return kTcTileK / group + 1;
}

// One warp's A fragments for 16 stored rows (words w0..w3 = rows t, t + 4,
// t + 8, t + 12; column word c) and its mmas with every B fragment.
template <int MI, int L>
__device__ __forceinline__ void tc_step(float (*acc)[MI][4],
                                        const uint32_t (*wv)[2],
                                        const uint32_t (*b)[2],
                                        const float4* s, const float4* zf,
                                        int shift) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float sc[4] = {s[c].x, s[c].y, s[c].z, s[c].w};
    const float zc[4] = {zf[c].x, zf[c].y, zf[c].z, zf[c].w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b0 = 2 * h, b1 = 2 * h + 1;  // bytes of fragment rows g, g+8
      const int s0 = 8 * b0 + shift, s1 = 8 * b1 + shift;
      uint32_t a[4];
      a[0] = pack_bf16(dequant<L>(wv[0][c], s0, sc[b0], zc[b0]),
                       dequant<L>(wv[1][c], s0, sc[b0], zc[b0]));
      a[1] = pack_bf16(dequant<L>(wv[0][c], s1, sc[b1], zc[b1]),
                       dequant<L>(wv[1][c], s1, sc[b1], zc[b1]));
      a[2] = pack_bf16(dequant<L>(wv[2][c], s0, sc[b0], zc[b0]),
                       dequant<L>(wv[3][c], s0, sc[b0], zc[b0]));
      a[3] = pack_bf16(dequant<L>(wv[2][c], s1, sc[b1], zc[b1]),
                       dequant<L>(wv[3][c], s1, sc[b1], zc[b1]));
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) mma_bf16(acc[2 * c + h][mi], a, b[mi]);
    }
  }
}

template <int MI, int L>
__global__ void __launch_bounds__(kThreads)
qmm_tc_kernel(const uint16_t* __restrict__ x, const uint32_t* __restrict__ w,
              const float* __restrict__ scales,
              const float* __restrict__ zeros, __nv_bfloat16* __restrict__ out,
              float* __restrict__ partial, int* __restrict__ counters, int M,
              int K, int N, int group, int chunk) {
  constexpr int MT = 8 * MI;
  constexpr int halves = (L == kW4Packed) ? 2 : 1;
  constexpr int XPW = halves * kTcTileK / 2 + 4;  // x row pitch (words)
  extern __shared__ uint32_t xs[];                // [MT][XPW] bf16 pairs
  uint16_t* xs16 = reinterpret_cast<uint16_t*>(xs);
  // Then [halves][GT][kTcBlockN] scales and the same of 2^23 + zeros.
  const int GT = (L == kW8) ? 0 : tc_tile_groups(group);
  float* s_s = reinterpret_cast<float*>(xs + MT * XPW);
  float* z_s = s_s + halves * GT * kTcBlockN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % kTcWarpsN, wk = warp / kTcWarpsN;
  const int m0 = blockIdx.z * MT;
  const int Ks = (L == kW4Packed) ? K / 2 : K;
  const int G = (L == kW8) ? 1 : K / group;
  const int r_begin = blockIdx.y * chunk;
  const int r_end = min(Ks, r_begin + chunk);
  const int words = N / 4;
  const int col0 = blockIdx.x * kTcBlockN;        // block's first column
  int wcol[2];
  bool wok[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    wcol[c] = (col0 + wn * kTcWarpN) / 4 + g + 8 * c;
    wok[c] = wcol[c] < words;
  }

  float acc[4][MI][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][mi][e] = 0.f;

  // wv[st][rr][c]: step st's stored row t + 4 rr, column word c.
  uint32_t next[kTcSteps][4][2];
  auto load_unit = [&](int u0) {
#pragma unroll
    for (int st = 0; st < kTcSteps; ++st)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int row = u0 + 16 * st + t + 4 * rr;
          next[st][rr][c] = (row < r_end && wok[c])
                                ? __ldg(w + (size_t)row * words + wcol[c])
                                : 0u;
        }
  };
  // Warp (wn, wk) takes columns [wn * 64, wn * 64 + 64) of the block and
  // rows [wk * 128, wk * 128 + 128) of every x tile: kUnits units of rows.
  constexpr int kRows = kTcTileK / kTcWarpsK;
  constexpr int kUnits = kRows / kTcUnit;
  load_unit(r_begin + wk * kRows);
  for (int t0 = r_begin; t0 < r_end; t0 += kTcTileK) {
    __syncthreads();  // the previous tile is consumed
    // xs16[m * 2 XPW + h * kTcTileK + 16 q + i] = x[m0 + m, t0 + h Ks +
    // 16 q + perm(i)] with perm(2u) = u, perm(2u + 1) = u + 4 (+ 8 for
    // i >= 8); each thread moves 8 consecutive x values at a time.
    constexpr int vecs = MT * halves * kTcTileK / 8;
    for (int i = threadIdx.x; i < vecs; i += kThreads) {
      const int m = i / (halves * kTcTileK / 8);
      const int hr = 8 * (i - m * (halves * kTcTileK / 8));
      const int h = hr / kTcTileK, r = hr - h * kTcTileK;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + m < M && t0 + r < r_end)
        v = __ldg(reinterpret_cast<const uint4*>(
            x + (size_t)(m0 + m) * K + t0 + h * Ks + r));
      const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
      uint16_t* row = xs16 + (size_t)m * 2 * XPW + h * kTcTileK;
#pragma unroll
      for (int e8 = 0; e8 < 8; ++e8) {
        const int e = (r & 15) + e8;  // source position in its 16-group
        const int pos = (r & ~15) + 2 * (e & 3) + ((e >> 2) & 1) + (e & 8);
        row[pos] = (uint16_t)(vw[e8 / 2] >> (16 * (e8 & 1)));
      }
    }
    for (int i = threadIdx.x; i < halves * GT * kTcBlockN / 4;
         i += kThreads) {
      const int hg = i / (kTcBlockN / 4), c4 = 4 * (i % (kTcBlockN / 4));
      const int h = hg / GT, gi = (t0 + h * Ks) / group + hg % GT;
      float4 sv = make_float4(0.f, 0.f, 0.f, 0.f), zv = sv;
      if (gi < G && col0 + c4 < N) {
        sv = __ldg(reinterpret_cast<const float4*>(
            scales + (size_t)gi * N + col0 + c4));
        zv = __ldg(reinterpret_cast<const float4*>(
            zeros + (size_t)gi * N + col0 + c4));
      }
      *reinterpret_cast<float4*>(s_s + hg * kTcBlockN + c4) = sv;
      *reinterpret_cast<float4*>(z_s + hg * kTcBlockN + c4) =
          make_float4(8388608.f + zv.x, 8388608.f + zv.y,
                      8388608.f + zv.z, 8388608.f + zv.w);
    }
    __syncthreads();
    for (int i = 0; i < kUnits; ++i) {
      const int u0 = t0 + wk * kRows + kTcUnit * i;
      if (u0 >= r_end) break;  // warp-uniform
      uint32_t wv[kTcSteps][4][2];
#pragma unroll
      for (int st = 0; st < kTcSteps; ++st)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int c = 0; c < 2; ++c) wv[st][rr][c] = next[st][rr][c];
      const int u1 =  // the warp's next unit, in this tile or the next
          i + 1 < kUnits ? u0 + kTcUnit : t0 + kTcTileK + wk * kRows;
      if (u1 < r_end) load_unit(u1);

      // This unit's scales and zeros (a unit never straddles a group).
      float4 sl[2], zl[2], sh[2], zh[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        sl[c] = zl[c] = sh[c] = zh[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (L == kW8) continue;
        const int cc = wn * kTcWarpN + 4 * (g + 8 * c);
        const int gl = u0 / group - t0 / group;
        sl[c] = *reinterpret_cast<const float4*>(s_s + gl * kTcBlockN + cc);
        zl[c] = *reinterpret_cast<const float4*>(z_s + gl * kTcBlockN + cc);
        if (L == kW4Packed) {
          const int gh = GT + (u0 + Ks) / group - (t0 + Ks) / group;
          sh[c] = *reinterpret_cast<const float4*>(s_s + gh * kTcBlockN + cc);
          zh[c] = *reinterpret_cast<const float4*>(z_s + gh * kTcBlockN + cc);
        }
      }
#pragma unroll
      for (int st = 0; st < kTcSteps; ++st) {
        // B fragments: words (row - t0) / 2 + t and + 4 of each row of M.
        const int xw = (u0 + 16 * st - t0) / 2 + t;
        uint32_t bl[MI][2], bh[MI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const uint32_t* xr = xs + (size_t)(8 * mi + g) * XPW + xw;
          bl[mi][0] = xr[0];
          bl[mi][1] = xr[4];
          if (L == kW4Packed) {
            bh[mi][0] = xr[kTcTileK / 2];
            bh[mi][1] = xr[kTcTileK / 2 + 4];
          }
        }
        tc_step<MI, L>(acc, wv[st], bl, sl, zl, 0);
        if (L == kW4Packed) tc_step<MI, L>(acc, wv[st], bh, sh, zh, 4);
      }
    }
  }

  // The K warps' sums meet in shared memory (over the x tile).
  __syncthreads();
  float* red = reinterpret_cast<float*>(xs);  // [kTcWarpsN][16 MI][32]
  if (wk > 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((wn * 4 + j) * MI * 4 + mi * 4 + e) * 32 + lane] =
              acc[j][mi][e];
  }
  __syncthreads();
  if (wk == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][mi][e] +=
              red[((wn * 4 + j) * MI * 4 + mi * 4 + e) * 32 + lane];
  }
  // Lane (g, t) of a wk = 0 warp holds y[m, n], y[m, n + 1] for n = 4 (g +
  // 8 c) + 2 h of the warp's columns and m = 8 mi + 2 t (+ 1).
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (!wok[c] || wk > 0) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 4 * wcol[c] + 2 * h;
      float2 sn = make_float2(1.f, 1.f);
      if (L == kW8 && partial == nullptr)
        sn = __ldg(reinterpret_cast<const float2*>(scales + n));
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const float* a = acc[2 * c + h][mi];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * mi + 2 * t + e;
          if (m >= M) continue;
          if (partial != nullptr) {
            *reinterpret_cast<float2*>(
                partial + ((size_t)blockIdx.y * M + m) * N + n) =
                make_float2(a[e], a[e + 2]);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
                __floats2bfloat162_rn(a[e] * sn.x, a[e + 2] * sn.y);
          }
        }
      }
    }
  }
  if (partial != nullptr)
    finish_splits<__nv_bfloat16, L>(partial, counters, scales, out, M, N, m0,
                                    MT, col0, kTcBlockN);
}

template <int MI, int L>
int launch_tc(const void* x, const void* w, const float* scales,
              const float* zeros, void* out, float* partial, int* counters,
              int M, int K, int N, int group, int splits, int chunk,
              cudaStream_t stream) {
  constexpr int halves = (L == kW4Packed) ? 2 : 1;
  const int GT = (L == kW8) ? 0 : tc_tile_groups(group);
  const int smem = 8 * MI * (halves * kTcTileK / 2 + 4) * sizeof(uint32_t) +
                   2 * halves * GT * kTcBlockN * sizeof(float);
  cudaError_t err = allow_smem<qmm_tc_kernel<MI, L>>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTcBlockN - 1) / kTcBlockN, splits,
                  (M + 8 * MI - 1) / (8 * MI));
  qmm_tc_kernel<MI, L><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint32_t*>(w),
      scales, zeros, static_cast<__nv_bfloat16*>(out),
      splits > 1 ? partial : nullptr, counters, M, K, N, group, chunk);
  return (int)cudaGetLastError();
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
int launch(int dtype, int mt, int tc, const void* x, const void* w,
           const float* scales, const float* zeros, void* out,
           float* partial, int* counters, int M, int K, int N, int group,
           int splits, int chunk, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (N % 4 != 0 || M < 1 || splits < 1 ||
      (splits > 1 && (partial == nullptr || counters == nullptr)) ||
      (L != kW8 && (group < 1 || K % group != 0)) ||
      (tc && (dtype != kBFloat16 || chunk % kTcTileK != 0 || K % 32 != 0 ||
              (L != kW8 && group % kTcUnit != 0))) ||
      (!tc && (dtype != kFloat32 || chunk % kTileK != 0)))
    return (int)cudaErrorInvalidValue;
  if (tc) {
    switch (mt) {
      case 8:
        return launch_tc<1, L>(x, w, scales, zeros, out, partial, counters,
                               M, K, N, group, splits, chunk, s);
      case 16:
        return launch_tc<2, L>(x, w, scales, zeros, out, partial, counters,
                               M, K, N, group, splits, chunk, s);
      case 32:
        return launch_tc<4, L>(x, w, scales, zeros, out, partial, counters,
                               M, K, N, group, splits, chunk, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  return launch_t<float, L>(mt, x, w, scales, zeros, out, partial, counters,
                            M, K, N, group, splits, chunk, s);
}

}  // namespace

// Entry points (ctypes). mt: rows of M per block (8, 16 or 32); tc: 1 for
// the bf16 tensor-core kernel, 0 for the fp32 CUDA-core one; out [M, N] in
// x's dtype. With splits > 1, partial is fp32 [splits, M, N] scratch and
// counters one int per (column tile, M tile), zero before the launch and
// zero after it; with splits == 1 both may be null. chunk: stored weight
// rows per split (a multiple of 256 with tc, of 128 without). Return a
// cudaError_t.
extern "C" int w8a16_launch(int dtype, int mt, int tc, const void* x,
                            const void* q, const float* scales, void* out,
                            float* partial, int* counters, int M, int K,
                            int N, int splits, int chunk, void* stream) {
  return launch<kW8>(dtype, mt, tc, x, q, scales, nullptr, out, partial,
                     counters, M, K, N, 1, splits, chunk, stream);
}

extern "C" int w4a16_launch(int dtype, int mt, int tc, const void* x,
                            const void* q, const float* scales,
                            const float* zeros, void* out, float* partial,
                            int* counters, int M, int K, int N, int group,
                            int splits, int chunk, void* stream) {
  return launch<kW4>(dtype, mt, tc, x, q, scales, zeros, out, partial,
                     counters, M, K, N, group, splits, chunk, stream);
}

extern "C" int w4a16_packed_launch(int dtype, int mt, int tc, const void* x,
                                   const void* qpacked, const float* scales,
                                   const float* zeros, void* out,
                                   float* partial, int* counters, int M,
                                   int K, int N, int group, int splits,
                                   int chunk, void* stream) {
  return launch<kW4Packed>(dtype, mt, tc, x, qpacked, scales, zeros, out,
                           partial, counters, M, K, N, group, splits, chunk,
                           stream);
}
