// The ragged kernel's fp16 tensor-core instances with bidirectional image
// spans (rpa_tc_kernel with T = __half and kSpans: Gemma-3 multimodal in
// fp16), ALiBi a uniform branch in them, CUDA, sm_90a.
// csrc/ragged_paged_attention.cu describes the kernel and its span mask;
// the instances are built here, in a translation unit of their own, so
// that nvcc compiles them beside the bf16 span instances
// (csrc/ragged_spans.cu) and the fp16 ones without spans
// (csrc/ragged_f16.cu).
#include "ragged_tc.cuh"

// The fp16 tensor-core kernel with image spans (dtype must be kFloat16:
// csrc/ragged_spans.cu takes bf16; head_dim a multiple of 16 up to 256;
// the cache fp16 or fp8, kv_dtype a KvDtype code; spans int32 [R, num_spans, 2] (lo,
// hi) per image, -1 padding; alibi [nq] fp32 slopes or null). block_q *
// (nq / kvh) must fit the instance's rows.
extern "C" int rpa_tc_spans_f16_launch(int dtype, int kv_dtype,
                                       const void* q,
                                       const void* cache_layer, void* out,
                                       const int* item_req,
                                       const int* item_qstart,
                                       const int* item_qlen,
                                       const int* item_pos,
                                       const int* seq_lens,
                                       const int* block_tables, int num_items,
                                       int max_pages, int nq, int kvh,
                                       int page_size, int hd, int block_q,
                                       float scale, int sliding_window,
                                       int chunk_attn, float soft_cap,
                                       const float* alibi, const int* spans,
                                       int num_spans, void* stream) {
  return rpa_tc_dispatch<true, __half>(
      dtype, kv_dtype, q, cache_layer, out, item_req, item_qstart, item_qlen,
      item_pos, seq_lens, block_tables, num_items, max_pages, nq, kvh,
      page_size, hd, block_q, scale, sliding_window, chunk_attn, soft_cap,
      alibi, spans, num_spans, static_cast<cudaStream_t>(stream));
}
