// Window decode attention (CUDA, sm_90a).
//
// Replaces the TPU kernel `window_decode_attention` / `_wd_kernel` of
// aphrodite_tpu/ops/window_decode_attention.py. During a decode window the
// paged KV cache is frozen; each request r has one query token at position
// paged_lens[r] + step, which attends to the pages' positions
// < paged_lens[r] and to the tail slots j <= step that this window has
// written so far (tail [R, kvh, Kw, hd] of one layer). Sliding window,
// chunked local attention and logit soft cap mask as in the TPU kernel.
// Fully masked rows give 0, never NaN.
//
// Design. One block runs one (request, KV head) with its group of query
// rows (6 at Qwen2.5-1.5B geometry). The visible keys are cut into tiles
// of 32 (page tiles, then tail tiles); warp w takes tiles w, w + W, ...
// and keeps its own online-softmax state for the group rows. Each warp
// stages its tile of K and V in its own shared memory, lane j owning key
// j. At the end the block merges the W warps' states. The wrapper picks W
// (4, else 2, else 1) so that the tiles fit the card's shared memory
// (ops/window_decode_attention.py: window_warps): 2 at head_dim 256.
//
// Bound. One launch at the main path's shapes (R 32, kvh 2, hd 128,
// context ~525) reads ~17 MB of K/V in bf16: it is bound by bytes, >= 5 us
// at 3.35 TB/s. With R * kvh = 64 blocks on 132 SMs this simple version
// cannot reach that; split-KV across more blocks is the next step.
#include "attn_common.cuh"

namespace {

constexpr int kMaxWarps = 4;

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
wd_kernel(const T* __restrict__ q, const T* __restrict__ cache,
          const T* __restrict__ tail_k, const T* __restrict__ tail_v,
          T* __restrict__ out, const int* __restrict__ paged_lens,
          const int* __restrict__ block_tables, int max_pages, int nq,
          int kvh, int page_size, int hd, int kw, int step, float scale,
          int sliding_window, int chunk_attn, float soft_cap) {
  using namespace attn;
  const int r = blockIdx.x, h = blockIdx.y;
  const int group = nq / kvh;
  const int plen = paged_lens[r], q_pos = plen + step;
  const int tile = min(page_size, kTile);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;

  extern __shared__ float smem[];
  float* q_s = smem;                                    // [group, hd]
  const size_t per_warp = (size_t)kTile * (hd + 1) + kTile * hd + kTile +
                          (size_t)group * hd + 2 * group;
  float* w_s = q_s + (size_t)group * hd + warp * per_warp;
  float* k_s = w_s;                                     // [kTile, hd + 1]
  float* v_s = k_s + kTile * (hd + 1);                  // [kTile, hd]
  float* p_w = v_s + kTile * hd;                        // [kTile]
  float* acc_w = p_w + kTile;                           // [group, hd]
  float* m_w = acc_w + (size_t)group * hd;              // [group]
  float* l_w = m_w + group;                             // [group]

  for (int i = threadIdx.x; i < group * hd; i += blockDim.x)
    q_s[i] = to_float(q[((size_t)r * nq + h * group) * hd + i]);
  for (int i = lane; i < group * hd; i += 32) acc_w[i] = 0.f;
  for (int g = lane; g < group; g += 32) {
    m_w[g] = -INFINITY;
    l_w[g] = 0.f;
  }
  __syncthreads();

  const size_t page_elems = (size_t)page_size * hd;
  const int lo = min(first_visible(q_pos, sliding_window, chunk_attn), plen);
  const int t0 = lo / tile;
  const int n_paged = (plen + tile - 1) / tile - t0;
  const int n_tail = (step + 1 + kTile - 1) / kTile;
  const size_t tail_base = ((size_t)r * kvh + h) * kw * hd;
  for (int t = warp; t < n_paged + n_tail; t += n_warps) {
    const T *kb, *vb;
    int n, kv0;
    if (t < n_paged) {
      kv0 = (t0 + t) * tile;
      n = min(tile, plen - kv0);
      const int page_id =
          block_tables[(size_t)r * max_pages + kv0 / page_size];
      const size_t base = ((size_t)page_id * 2 * kvh + h) * page_elems +
                          (size_t)(kv0 % page_size) * hd;
      kb = cache + base;
      vb = cache + base + kvh * page_elems;
    } else {
      const int j0 = (t - n_paged) * kTile;
      kv0 = plen + j0;
      n = min(kTile, step + 1 - j0);
      kb = tail_k + tail_base + (size_t)j0 * hd;
      vb = tail_v + tail_base + (size_t)j0 * hd;
    }
    __syncwarp();  // this warp's previous tile fully consumed
    load_tile(kb, vb, n, hd, k_s, v_s, lane, 32);
    __syncwarp();
    const int kv_pos = kv0 + lane;
    const bool valid =
        lane < n && local_ok(kv_pos, q_pos, sliding_window, chunk_attn);
    for (int g = 0; g < group; ++g)
      tile_update(q_s + (size_t)g * hd, k_s, v_s, n, hd, valid, scale,
                  soft_cap, acc_w + (size_t)g * hd, m_w + g, l_w + g, p_w,
                  lane);
  }
  __syncthreads();

  // Merge the warps' online-softmax states.
  for (int i = threadIdx.x; i < group * hd; i += blockDim.x) {
    const int g = i / hd;
    float m = -INFINITY;
    for (int w = 0; w < n_warps; ++w)
      m = fmaxf(m, q_s[group * hd + w * per_warp + kTile * (2 * hd + 2) +
                       (size_t)group * hd + g]);
    float acc = 0.f, l = 0.f;
    if (m != -INFINITY) {
      for (int w = 0; w < n_warps; ++w) {
        const float* ws = q_s + (size_t)group * hd + w * per_warp;
        const float* aw = ws + kTile * (2 * hd + 2);
        const float mw = aw[(size_t)group * hd + g];
        if (mw == -INFINITY) continue;
        const float c = expf(mw - m);
        acc += aw[i] * c;
        l += aw[(size_t)group * hd + group + g] * c;
      }
    }
    out[((size_t)r * nq + h * group) * hd + i] =
        from_float<T>(acc / fmaxf(l, 1e-20f));
  }
}

template <typename T>
int launch(const void* q, const void* cache, const void* tail_k,
           const void* tail_v, void* out, const int* paged_lens,
           const int* block_tables, int num_reqs, int max_pages, int nq,
           int kvh, int page_size, int hd, int kw, int step, float scale,
           int sliding_window, int chunk_attn, float soft_cap, int warps,
           int smem_bytes, cudaStream_t stream) {
  // smem_bytes (computed by the wrapper): q [group, hd], then per warp a K
  // tile [kTile, hd + 1], a V tile [kTile, hd], p [kTile], acc [group, hd],
  // m and l [group], all fp32.
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  wd_kernel<T><<<dim3(num_reqs, kvh), warps * 32, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cache),
      static_cast<const T*>(tail_k), static_cast<const T*>(tail_v),
      static_cast<T*>(out), paged_lens, block_tables, max_pages, nq, kvh,
      page_size, hd, kw, step, scale, sliding_window, chunk_attn, soft_cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wd_launch(int dtype, const void* q, const void* cache_layer,
                         const void* tail_k_layer, const void* tail_v_layer,
                         void* out, const int* paged_lens,
                         const int* block_tables, int num_reqs, int max_pages,
                         int nq, int kvh, int page_size, int hd, int kw,
                         int step, float scale, int sliding_window,
                         int chunk_attn, float soft_cap, int warps,
                         int smem_bytes, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, cache_layer, tail_k_layer, tail_v_layer, out,
                         paged_lens, block_tables, num_reqs, max_pages, nq,
                         kvh, page_size, hd, kw, step, scale, sliding_window,
                         chunk_attn, soft_cap, warps, smem_bytes, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, cache_layer, tail_k_layer, tail_v_layer,
                                 out, paged_lens, block_tables, num_reqs,
                                 max_pages, nq, kvh, page_size, hd, kw, step,
                                 scale, sliding_window, chunk_attn, soft_cap,
                                 warps, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
