// Ragged paged attention for prefill and mixed waves (CUDA, sm_90a).
//
// Replaces the TPU kernel `ragged_paged_attention` / `_rpa_kernel` of
// aphrodite_tpu/ops/ragged_paged_attention.py. It computes the same
// function: causal attention of a ragged batch of query tokens
// q [T, nq, hd] over each request's KV pages, read through block_tables
// from one layer of the cache [P, 2, kvh, page, hd], with optional sliding
// window, chunked local attention and logit soft cap. Fully masked rows
// give 0 (acc / max(l, 1e-20)), never NaN.
//
// Design. The host cuts each request's scheduled tokens into work items of
// up to block_q tokens. One block runs one (work item, KV head): its rows
// are the item's tokens times the group of query heads sharing that KV
// head, held in shared memory as float with their float accumulators. The
// block walks the request's KV positions in tiles of 32 keys (a page is
// 64 tokens here, so two tiles per page); all threads stage a tile of K
// and V into shared memory, then each warp updates its own rows with an
// online softmax, lane j owning key j. Output goes straight to the flat
// [T, nq, hd] layout: no per-item buffer and no regather. The wrapper
// sizes block_q so that this layout fits the card's shared memory
// (ops/ragged_paged_attention.py: ragged_block_q, ragged_smem_bytes) and
// passes the bytes: 128 rows at head_dim 128, 80 at head_dim 256.
//
// Bound. One prefill wave at the main path's shapes (32 requests x 500
// tokens, nq 12, kvh 2, hd 128) is ~25 GFLOP of QK^T and PV against
// ~115 MB of q, K/V and output, so it is bound by operations: >= 25 us at
// the bf16 tensor-core peak. This first version does its products on the
// CUDA cores in fp32, so it runs far from that bound; tensor cores (wgmma)
// and TMA staging are the next steps.
#include "attn_common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rpa_kernel(const T* __restrict__ q, const T* __restrict__ cache,
           T* __restrict__ out, const int* __restrict__ item_req,
           const int* __restrict__ item_qstart,
           const int* __restrict__ item_qlen,
           const int* __restrict__ item_pos,
           const int* __restrict__ seq_lens,
           const int* __restrict__ block_tables, int max_pages, int nq,
           int kvh, int page_size, int hd, int block_q, float scale,
           int sliding_window, int chunk_attn, float soft_cap) {
  using namespace attn;
  const int item = blockIdx.x, h = blockIdx.y;
  const int group = nq / kvh;
  const int req = item_req[item], qstart = item_qstart[item];
  const int qlen = item_qlen[item], pos0 = item_pos[item];
  const int rows = qlen * group, rows_max = block_q * group;
  const int kv_limit = min(pos0 + qlen, seq_lens[req]);
  const int tile = min(page_size, kTile);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ float smem[];
  float* q_s = smem;                              // [rows_max, hd]
  float* acc_s = q_s + (size_t)rows_max * hd;     // [rows_max, hd]
  float* m_s = acc_s + (size_t)rows_max * hd;     // [rows_max]
  float* l_s = m_s + rows_max;                    // [rows_max]
  float* k_s = l_s + rows_max;                    // [kTile, hd + 1]
  float* v_s = k_s + kTile * (hd + 1);            // [kTile, hd]
  float* p_s = v_s + kTile * hd;                  // [kWarps, kTile]

  // Row r = token t * group + g reads query head h * group + g.
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const int t = r / group, g = r - t * group;
    q_s[i] = to_float(q[((size_t)(qstart + t) * nq + h * group + g) * hd + d]);
    acc_s[i] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  const size_t page_elems = (size_t)page_size * hd;
  const int lo = first_visible(pos0, sliding_window, chunk_attn);
  for (int kv0 = (lo / tile) * tile; kv0 < kv_limit; kv0 += tile) {
    const int n = min(tile, kv_limit - kv0);
    const int page_id = block_tables[(size_t)req * max_pages + kv0 / page_size];
    const size_t base = ((size_t)page_id * 2 * kvh + h) * page_elems +
                        (size_t)(kv0 % page_size) * hd;
    __syncthreads();  // previous tile fully consumed
    load_tile(cache + base, cache + base + kvh * page_elems, n, hd, k_s,
              v_s, threadIdx.x, blockDim.x);
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      const int q_pos = pos0 + r / group;
      if (kv0 > q_pos) continue;  // whole tile in this row's future
      const int kv_pos = kv0 + lane;
      const bool valid = lane < n && kv_pos <= q_pos &&
                         local_ok(kv_pos, q_pos, sliding_window, chunk_attn);
      tile_update(q_s + (size_t)r * hd, k_s, v_s, n, hd, valid, scale,
                  soft_cap, acc_s + (size_t)r * hd, m_s + r, l_s + r,
                  p_s + warp * kTile, lane);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const int t = r / group, g = r - t * group;
    out[((size_t)(qstart + t) * nq + h * group + g) * hd + d] =
        from_float<T>(acc_s[i] / fmaxf(l_s[r], 1e-20f));
  }
}

template <typename T>
int launch(const void* q, const void* cache, void* out, const int* item_req,
           const int* item_qstart, const int* item_qlen, const int* item_pos,
           const int* seq_lens, const int* block_tables, int num_items,
           int max_pages, int nq, int kvh, int page_size, int hd, int block_q,
           float scale, int sliding_window, int chunk_attn, float soft_cap,
           int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rpa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  rpa_kernel<T><<<dim3(num_items, kvh), kWarps * 32, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cache),
      static_cast<T*>(out), item_req, item_qstart, item_qlen, item_pos,
      seq_lens, block_tables, max_pages, nq, kvh, page_size, hd, block_q,
      scale, sliding_window, chunk_attn, soft_cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rpa_launch(int dtype, const void* q, const void* cache_layer,
                          void* out, const int* item_req,
                          const int* item_qstart, const int* item_qlen,
                          const int* item_pos, const int* seq_lens,
                          const int* block_tables, int num_items,
                          int max_pages, int nq, int kvh, int page_size,
                          int hd, int block_q, float scale,
                          int sliding_window, int chunk_attn, float soft_cap,
                          int smem_bytes, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, cache_layer, out, item_req, item_qstart,
                         item_qlen, item_pos, seq_lens, block_tables,
                         num_items, max_pages, nq, kvh, page_size, hd,
                         block_q, scale, sliding_window, chunk_attn,
                         soft_cap, smem_bytes, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, cache_layer, out, item_req, item_qstart,
                                 item_qlen, item_pos, seq_lens, block_tables,
                                 num_items, max_pages, nq, kvh, page_size, hd,
                                 block_q, scale, sliding_window, chunk_attn,
                                 soft_cap, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
