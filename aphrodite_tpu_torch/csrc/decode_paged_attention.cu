// Decode paged attention (CUDA, sm_90a).
//
// Replaces the TPU kernel `decode_paged_attention` / `_decode_kernel` of
// aphrodite_tpu/ops/decode_paged_attention.py. Each request r has one query
// token at position pos = seq_lens[r] - 1 (its K/V already written to the
// pages); it attends keys 0..pos of the request, read through block_tables
// from one layer of the cache [P, 2, kvh, page, hd]. Options, as in the TPU
// kernel: sliding window, chunked local attention, logit soft cap and ALiBi
// (slope[q head] * (kv_pos - pos), added BEFORE the soft cap as the TPU
// kernel adds it, decode_paged_attention.py:97-110; the JAX oracle adds it
// after, backend.py:170-178). A row with seq_len 0 gives zeros; a fully
// masked row gives 0, never NaN.
//
// Design. One block runs one (request, KV head) with its group of query
// rows (2 at Gemma-2-9B geometry). The visible keys are cut into tiles of
// 32; warp w takes tiles w, w + W, ... and keeps its own online-softmax
// state for the group rows; at the end the block merges the W states. Each
// warp stages its tile in its own shared memory in the cache's dtype, as
// 32-bit words (two bf16 values each), so a bf16 tile takes half the bytes
// of an fp32 one and four warps fit at head_dim 256; K rows are padded by
// one word so that lane j, reading key j, hits a distinct bank. The wrapper
// (ops/decode_paged_attention.py) picks W (4, else 2, else 1) to fit the
// card's shared memory and passes the bytes; it raises when none fits.
//
// Bound. At the Gemma-2-9B decode step (R 32, kvh 8, hd 256, ~545 keys) a
// launch reads ~143 MB of bf16 K/V: bound by bytes, >= 43 us at 3.35 TB/s.
// This first version computes on the CUDA cores in fp32 with R * kvh
// blocks (256 there) and 4-byte loads; split-KV over more blocks, 16-byte
// loads and a cp.async ring are the next steps.
#include "attn_common.cuh"

namespace {

constexpr int kMaxWarps = 4;

// q_row . key, the key a staged row of 32-bit words.
template <typename T>
__device__ __forceinline__ float dot_words(const float* q_row,
                                           const unsigned* k_row, int words);
template <>
__device__ __forceinline__ float dot_words<float>(const float* q_row,
                                                  const unsigned* k_row,
                                                  int words) {
  float dot = 0.f;
  for (int w = 0; w < words; ++w)
    dot = fmaf(q_row[w], __uint_as_float(k_row[w]), dot);
  return dot;
}
template <>
__device__ __forceinline__ float dot_words<__nv_bfloat16>(
    const float* q_row, const unsigned* k_row, int words) {
  float dot = 0.f;
  for (int w = 0; w < words; ++w) {
    const unsigned u = k_row[w];
    const float2 k =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
    dot = fmaf(q_row[2 * w], k.x, dot);
    dot = fmaf(q_row[2 * w + 1], k.y, dot);
  }
  return dot;
}

// One warp's online-softmax update of one query row against its staged
// tile (attn::tile_update, with the ALiBi bias and values in T). Lane j owns
// key j; `valid` says whether that key is visible to the row.
template <typename T>
__device__ __forceinline__ void row_update(
    const float* q_row, const unsigned* k_s, const T* v_s, int n, int hd,
    int words, bool valid, float scale, float bias, float soft_cap,
    float* acc_row, float* m, float* l, float* p_w, int lane) {
  using namespace attn;
  float s = -INFINITY;
  if (valid) {
    s = dot_words<T>(q_row, k_s + lane * (words + 1), words) * scale + bias;
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
    for (int j = 0; j < n; ++j)
      acc = fmaf(p_w[j], to_float(v_s[j * hd + d]), acc);
    acc_row[d] = acc_row[d] * alpha + acc;
  }
  __syncwarp();
  if (lane == 0) {
    *m = m_new;
    *l = *l * alpha + psum;
  }
  __syncwarp();
}

// Per-warp shared memory, in 32-bit words: K tile [kTile, words + 1], V tile
// [kTile, words], p [kTile], acc [group, hd], m [group], l [group].
struct WarpSmem {
  unsigned* k;
  unsigned* v;
  float* p;
  float* acc;
  float* m;
  float* l;
  __device__ WarpSmem(float* base, int words, int group, int hd) {
    k = reinterpret_cast<unsigned*>(base);
    v = k + attn::kTile * (words + 1);
    p = reinterpret_cast<float*>(v + attn::kTile * words);
    acc = p + attn::kTile;
    m = acc + group * hd;
    l = m + group;
  }
};

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
dpa_kernel(const T* __restrict__ q, const T* __restrict__ cache,
           T* __restrict__ out, const int* __restrict__ seq_lens,
           const int* __restrict__ block_tables,
           const float* __restrict__ alibi, int max_pages, int nq, int kvh,
           int page_size, int hd, float scale, int sliding_window,
           int chunk_attn, float soft_cap) {
  using namespace attn;
  const int r = blockIdx.x, h = blockIdx.y;
  const int group = nq / kvh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const size_t q_off = ((size_t)r * nq + h * group) * hd;
  const int seq_len = seq_lens[r];
  if (seq_len <= 0) {  // no token: zeros (block-uniform, before any sync)
    for (int i = threadIdx.x; i < group * hd; i += blockDim.x)
      out[q_off + i] = from_float<T>(0.f);
    return;
  }
  const int q_pos = seq_len - 1;
  const int words = hd * (int)sizeof(T) / 4;  // 32-bit words of a K/V row
  const int tile = min(page_size, kTile);

  extern __shared__ float smem[];
  float* q_s = smem;  // [group, hd]
  const int per_warp =
      kTile * (2 * words + 1) + kTile + group * hd + 2 * group;
  WarpSmem ws(q_s + group * hd + warp * per_warp, words, group, hd);

  for (int i = threadIdx.x; i < group * hd; i += blockDim.x)
    q_s[i] = to_float(q[q_off + i]);
  for (int i = lane; i < group * hd; i += 32) ws.acc[i] = 0.f;
  for (int g = lane; g < group; g += 32) {
    ws.m[g] = -INFINITY;
    ws.l[g] = 0.f;
  }
  __syncthreads();

  const float* slopes = alibi != nullptr ? alibi + h * group : nullptr;
  const size_t page_elems = (size_t)page_size * hd;
  const int t0 = first_visible(q_pos, sliding_window, chunk_attn) / tile;
  const int n_tiles = q_pos / tile + 1 - t0;
  for (int t = warp; t < n_tiles; t += n_warps) {
    const int kv0 = (t0 + t) * tile;
    const int n = min(tile, q_pos + 1 - kv0);
    const int page_id = block_tables[(size_t)r * max_pages + kv0 / page_size];
    const size_t base = ((size_t)page_id * 2 * kvh + h) * page_elems +
                        (size_t)(kv0 % page_size) * hd;
    const unsigned* kb = reinterpret_cast<const unsigned*>(cache + base);
    const unsigned* vb =
        reinterpret_cast<const unsigned*>(cache + base + kvh * page_elems);
    __syncwarp();  // this warp's previous tile fully consumed
    for (int i = lane; i < n * words; i += 32) {
      const int j = i / words;
      ws.k[i + j] = kb[i];  // row j starts at j * (words + 1)
      ws.v[i] = vb[i];
    }
    __syncwarp();
    const int kv_pos = kv0 + lane;
    const bool valid =
        lane < n && local_ok(kv_pos, q_pos, sliding_window, chunk_attn);
    for (int g = 0; g < group; ++g) {
      const float bias =
          slopes != nullptr ? slopes[g] * (float)(kv_pos - q_pos) : 0.f;
      row_update<T>(q_s + g * hd, ws.k, reinterpret_cast<const T*>(ws.v), n,
                    hd, words, valid, scale, bias, soft_cap, ws.acc + g * hd,
                    ws.m + g, ws.l + g, ws.p, lane);
    }
  }
  __syncthreads();

  // Merge the warps' online-softmax states.
  for (int i = threadIdx.x; i < group * hd; i += blockDim.x) {
    const int g = i / hd;
    float m = -INFINITY;
    for (int w = 0; w < n_warps; ++w)
      m = fmaxf(m, WarpSmem(q_s + group * hd + w * per_warp, words, group, hd)
                       .m[g]);
    float acc = 0.f, l = 0.f;
    if (m != -INFINITY) {
      for (int w = 0; w < n_warps; ++w) {
        const WarpSmem o(q_s + group * hd + w * per_warp, words, group, hd);
        if (o.m[g] == -INFINITY) continue;
        const float c = expf(o.m[g] - m);
        acc += o.acc[i] * c;
        l += o.l[g] * c;
      }
    }
    out[q_off + i] = from_float<T>(acc / fmaxf(l, 1e-20f));
  }
}

template <typename T>
int launch(const void* q, const void* cache, void* out, const int* seq_lens,
           const int* block_tables, const float* alibi, int num_reqs,
           int max_pages, int nq, int kvh, int page_size, int hd, float scale,
           int sliding_window, int chunk_attn, float soft_cap, int warps,
           int smem_bytes, cudaStream_t stream) {
  // smem_bytes (computed by the wrapper): q [group, hd] fp32, then
  // `warps` WarpSmem regions.
  if (warps < 1 || warps > kMaxWarps || (hd * (int)sizeof(T)) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dpa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dpa_kernel<T><<<dim3(num_reqs, kvh), warps * 32, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cache),
      static_cast<T*>(out), seq_lens, block_tables, alibi, max_pages, nq, kvh,
      page_size, hd, scale, sliding_window, chunk_attn, soft_cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dpa_launch(int dtype, const void* q, const void* cache_layer,
                          void* out, const int* seq_lens,
                          const int* block_tables, const float* alibi,
                          int num_reqs, int max_pages, int nq, int kvh,
                          int page_size, int hd, float scale,
                          int sliding_window, int chunk_attn, float soft_cap,
                          int warps, int smem_bytes, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, cache_layer, out, seq_lens, block_tables, alibi,
                         num_reqs, max_pages, nq, kvh, page_size, hd, scale,
                         sliding_window, chunk_attn, soft_cap, warps,
                         smem_bytes, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, cache_layer, out, seq_lens, block_tables,
                                 alibi, num_reqs, max_pages, nq, kvh,
                                 page_size, hd, scale, sliding_window,
                                 chunk_attn, soft_cap, warps, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
