// Shared helpers of the attention kernels: type conversion, warp
// reductions, the online-softmax tile update and the C launch glue.
// Built with nvcc for sm_90a into one shared library per kernel source
// (aphrodite_tpu_torch/ops/cuda_build.py); bound with ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace attn {

constexpr int kTile = 32;  // keys per tile: one key per lane

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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
// to this row. Keys whose logit is masked contribute exactly 0.
__device__ __forceinline__ void tile_update(
    const float* q_row, const float* k_s, const float* v_s, int n, int hd,
    bool valid, float scale, float soft_cap, float* acc_row, float* m,
    float* l, float* p_w, int lane) {
  float s = -INFINITY;
  if (valid) {
    const float* kr = k_s + lane * (hd + 1);
    float dot = 0.f;
    for (int d = 0; d < hd; ++d) dot = fmaf(q_row[d], kr[d], dot);
    s = dot * scale;
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

}  // namespace attn

// dtype codes shared with the Python wrappers.
enum AttnDtype { kFloat32 = 0, kBFloat16 = 1 };

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
