// Shared helpers of the attention kernels: type conversion (the fp8 K/V
// cache's too), warp reductions, the online-softmax tile update and the C
// launch glue.
// Built with nvcc for sm_90a into one shared library per kernel source
// (aphrodite_tpu_torch/ops/cuda_build.py); bound with ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace attn {

constexpr int kTile = 32;  // keys per tile: one key per lane

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e5m2 x) {
  return static_cast<float>(x);
}

// The fp8 KV cache. Every TPU kernel upcasts an fp8 K/V tile to q's dtype
// before both products (e.g. ragged_paged_attention.py:194-196); e4m3 and
// e5m2 values are exact in fp16, bf16 and fp32, so the kernels here convert
// the staged bytes once and run their products as on a cache of q's dtype.
// One helper for all four kernels: a pair of bytes to an f16 pair by the
// hardware's cvt.rn.f16x2.e4m3x2 / .e5m2x2 (exact, NaN kept); for bf16
// queries then f16 -> fp32 -> bf16 (exact).
template <typename KV>
constexpr bool is_fp8 = std::is_same<KV, __nv_fp8_e4m3>::value ||
                        std::is_same<KV, __nv_fp8_e5m2>::value;

// The window's tails: bf16 beside an e5m2 cache, else the cache's dtype
// (the reference runner's tail dtype, aphrodite_tpu/worker/runner.py:519).
template <typename KV>
using tail_t = typename std::conditional<
    std::is_same<KV, __nv_fp8_e5m2>::value, __nv_bfloat16, KV>::type;

// Two fp8 values (the low 16 bits of `two`, the first in the low byte) as
// two values of T (__nv_bfloat16 or __half) in one register.
template <typename KV, typename T = __nv_bfloat16>
__device__ __forceinline__ uint32_t fp8x2_to(uint32_t two) {
  constexpr __nv_fp8_interpretation_t kind =
      std::is_same<KV, __nv_fp8_e5m2>::value ? __NV_E5M2 : __NV_E4M3;
  __half2 h =
      __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(two & 0xFFFFu), kind);
  if constexpr (std::is_same<T, __half>::value) {
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    const float2 f = __half22float2(h);
    __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
    return *reinterpret_cast<uint32_t*>(&b);
  }
}

// Sixteen fp8 values (v, first in its low byte) as sixteen T at dst
// (32 bytes, 16-byte aligned).
template <typename KV, typename T>
__device__ __forceinline__ void fp8x16_to(uint4 v, void* dst) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = fp8x2_to<KV, T>(w[i]);
    o[2 * i + 1] = fp8x2_to<KV, T>(w[i] >> 16);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(o[0], o[1], o[2], o[3]);
  d[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// The conversion pass of the tensor-core kernels: `rows` staged fp8 rows
// of HD bytes (K then V of a tile, as cp.async left them, 16 bytes a copy)
// into the tile layout of T that their ldmatrix code reads (rows of
// `pitch` elements), by `threads` threads from `tid`. The caller
// synchronises before and after.
template <typename KV, int HD, typename T>
__device__ __forceinline__ void convert_rows(const uint8_t* src, T* dst,
                                             int rows, int pitch, int tid,
                                             int threads) {
  constexpr int kChunks = HD / 16;
  for (int i = tid; i < rows * kChunks; i += threads) {
    const int j = i / kChunks, c = i - j * kChunks;
    fp8x16_to<KV, T>(
        *reinterpret_cast<const uint4*>(src + (size_t)j * HD + c * 16),
        dst + (size_t)j * pitch + c * 16);
  }
}

// bf16 -> fp16, exact inside fp16's range. A finite bf16 value past fp16's
// largest (65504) would round to inf; it saturates to +-65504 instead.
// Such a value reaches a kernel only as an fp16 K or V row that the bf16
// tail rounded up (at most to 65536), so saturation returns the row's
// magnitude to within 0.05 %; inf and NaN stay as they are.
__device__ __forceinline__ uint32_t bf16x2_to_f16x2(uint32_t two) {
  float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&two));
  if (fabsf(f.x) > 65504.f && fabsf(f.x) != INFINITY)
    f.x = copysignf(65504.f, f.x);
  if (fabsf(f.y) > 65504.f && fabsf(f.y) != INFINITY)
    f.y = copysignf(65504.f, f.y);
  __half2 h = __floats2half2_rn(f.x, f.y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The window's bf16 tail tile under fp16 queries (beside an e5m2 cache),
// converted in place in the fp16 tile that ldmatrix reads: `rows` rows of
// HD values at `pitch` elements, each 16-byte chunk by one thread. The
// caller synchronises before and after.
template <int HD>
__device__ __forceinline__ void bf16_rows_to_f16(void* tile, int rows,
                                                 int pitch, int tid,
                                                 int threads) {
  constexpr int kChunks = HD / 8;
  for (int i = tid; i < rows * kChunks; i += threads) {
    const int j = i / kChunks, c = i - j * kChunks;
    uint4* p = reinterpret_cast<uint4*>(reinterpret_cast<uint16_t*>(tile) +
                                        (size_t)j * pitch + c * 8);
    uint4 v = *p;
    v.x = bf16x2_to_f16x2(v.x);
    v.y = bf16x2_to_f16x2(v.y);
    v.z = bf16x2_to_f16x2(v.z);
    v.w = bf16x2_to_f16x2(v.w);
    *p = v;
  }
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy n <= kTile contiguous [n, hd] rows of K and V into shared memory as
// float. K rows are padded to hd+1 floats so that lane j reading key j
// hits a distinct bank. Called by the threads [first, first+count).
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ kb,
                                          const T* __restrict__ vb, int n,
                                          int hd, float* k_s, float* v_s,
                                          int first, int count) {
  for (int i = first; i < n * hd; i += count) {
    const int j = i / hd, d = i - j * hd;
    k_s[j * (hd + 1) + d] = to_float(kb[i]);
    v_s[i] = to_float(vb[i]);
  }
}

// One warp's online-softmax update of one query row against one key tile.
// Lane j owns key j. q_row: [hd] float; acc_row: [hd] float; m, l: the
// row's running max and sum (read by every lane, written by lane 0);
// p_w: this warp's [kTile] scratch. valid: whether key `lane` is visible
// to this row. bias: lane's ALiBi term, added to the scaled logit before
// the soft cap. Keys whose logit is masked contribute exactly 0.
__device__ __forceinline__ void tile_update(
    const float* q_row, const float* k_s, const float* v_s, int n, int hd,
    bool valid, float scale, float soft_cap, float* acc_row, float* m,
    float* l, float* p_w, int lane, float bias = 0.f) {
  float s = -INFINITY;
  if (valid) {
    const float* kr = k_s + lane * (hd + 1);
    float dot = 0.f;
    for (int d = 0; d < hd; ++d) dot = fmaf(q_row[d], kr[d], dot);
    s = dot * scale + bias;
    if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
  }
  const float m_prev = *m;
  const float m_new = fmaxf(m_prev, warp_max(s));
  if (m_new == -INFINITY) return;  // no visible key yet (warp-uniform)
  const float p = valid ? expf(s - m_new) : 0.f;
  const float alpha = (m_prev == -INFINITY) ? 0.f : expf(m_prev - m_new);
  const float psum = warp_sum(p);
  p_w[lane] = p;
  __syncwarp();
  for (int d = lane; d < hd; d += 32) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(p_w[j], v_s[j * hd + d], acc);
    acc_row[d] = acc_row[d] * alpha + acc;
  }
  __syncwarp();
  if (lane == 0) {
    *m = m_new;
    *l = *l * alpha + psum;
  }
  __syncwarp();
}

// Mask shared by both kernels: sliding window and chunked local attention
// relative to the query position (0 disables an option).
__device__ __forceinline__ bool local_ok(int kv_pos, int q_pos,
                                         int sliding_window, int chunk_attn) {
  if (sliding_window > 0 && kv_pos <= q_pos - sliding_window) return false;
  if (chunk_attn > 0 && kv_pos / chunk_attn != q_pos / chunk_attn)
    return false;
  return true;
}

// First key position a query at q_lo (the item's lowest position) can see.
__device__ __forceinline__ int first_visible(int q_lo, int sliding_window,
                                             int chunk_attn) {
  int lo = 0;
  if (sliding_window > 0) lo = q_lo - sliding_window + 1;
  if (chunk_attn > 0) lo = (q_lo / chunk_attn) * chunk_attn;
  return lo > 0 ? lo : 0;
}

// Bidirectional image spans (Gemma-3 multimodal: sp [M, 2], (lo, hi) per
// image of one request, -1 padding), shared by the ragged kernel's
// instances (csrc/ragged_tc.cuh, csrc/ragged_paged_attention.cu,
// csrc/mla_attention.cuh).
//
// Keys a block of the item [pos0, pos0 + qlen) of a request with image
// spans sp scans: its causal keys, and the keys of every span that meets
// its positions, below seq_len.
__device__ __forceinline__ int span_kv_limit(const int* __restrict__ sp,
                                             int num_spans, int pos0,
                                             int qlen, int seq_len) {
  int end = pos0 + qlen;
  for (int m = 0; m < num_spans; ++m) {
    const int lo = sp[2 * m], hi = sp[2 * m + 1];
    if (lo < pos0 + qlen && hi > pos0) end = max(end, hi);
  }
  return min(end, seq_len);
}

// The keys [lo, hi) a row at q_pos sees through the spans sp [M, 2]: the
// union of the spans that hold it (they overlap in q_pos, so the union is
// one interval); lo > hi where none does.
__device__ __forceinline__ void row_span(const int* __restrict__ sp,
                                         int num_spans, int q_pos, int& lo,
                                         int& hi) {
  lo = 0x7fffffff;
  hi = -1;
  for (int m = 0; m < num_spans; ++m) {
    const int a = sp[2 * m], b = sp[2 * m + 1];
    if (a <= q_pos && q_pos < b) {
      lo = min(lo, a);
      hi = max(hi, b);
    }
  }
}

}  // namespace attn

// dtype codes shared with the Python wrappers: q's, and the cache's (the
// cache in q's dtype, or fp8 e4m3fn / e5m2).
enum AttnDtype { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };
enum KvDtype { kKvAuto = 0, kKvE4M3 = 1, kKvE5M2 = 2 };

// The shared memory a block of the current device may opt in to
// (cudaDevAttrMaxSharedMemoryPerBlockOptin: 232,448 bytes on an H100). Every
// attention library exports it (each source is built on its own); the
// wrappers read it once and size their launches to it.
extern "C" int attn_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}
