// The ragged kernel's MLA option instances for bf16 queries (CUDA,
// sm_90a): mla_kernel<kCap, false, bf16, KV, true>, which takes image spans
// and ALiBi at head_dim 576 (csrc/mla_attention.cuh describes both), on a
// bf16 or fp8 cache. Built in a translation unit of their own, beside the
// instances without options (csrc/mla_attention.cu) and the fp16 option
// instances (csrc/mla_opts_f16.cu), so that nvcc compiles them side by
// side.
#include "mla_attention.cuh"

// Entry point (ctypes); returns a cudaError_t.
//
// mla_ragged_opts_launch: the ragged kernel's MLA option instance for bf16
// q (q_code 1) on a bf16 or fp8 cache (kv_code 0, or e4m3fn 1, e5m2 2),
// with ALiBi's slopes alibi [nq] fp32 and the image spans [R, num_spans,
// 2] int32 (num_spans >= 1), either null; the other arguments as
// ragged_entry's.
extern "C" int mla_ragged_opts_launch(
    int q_code, int kv_code, const void* q, const void* cache_layer,
    void* out, const int* item_req, const int* item_qstart,
    const int* item_qlen, const int* item_pos, const int* seq_lens,
    const int* block_tables, int num_items, int max_pages, int num_pages,
    int nq, int kvh, int page_size, int block_q, float scale,
    int sliding_window, int chunk_attn, float soft_cap, const float* alibi,
    const int* spans, int num_spans, void* stream) {
  return ragged_entry<bf16, true>(
      q_code, kv_code, q, cache_layer, out, item_req, item_qstart, item_qlen,
      item_pos, seq_lens, block_tables, num_items, max_pages, num_pages, nq,
      kvh, page_size, block_q, scale, sliding_window, chunk_attn, soft_cap,
      stream, alibi, spans, num_spans);
}
