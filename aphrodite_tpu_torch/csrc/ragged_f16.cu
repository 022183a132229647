// The ragged kernel's fp16 tensor-core instances (rpa_tc_kernel with T =
// __half: fp16 queries and output, products f32.f16.f16.f32), CUDA,
// sm_90a. csrc/ragged_paged_attention.cu describes the kernel; the
// instances are built here, in a translation unit of their own, so that
// nvcc compiles them beside the bf16 ones. The fp16 span instances are
// built in csrc/ragged_spans_f16.cu.
#include "ragged_tc.cuh"

// The fp16 tensor-core kernel without image spans (dtype must be
// kFloat16; head_dim a multiple of 16 up to 256; the cache fp16 or fp8, kv_dtype a
// KvDtype code; alibi [nq] fp32 slopes or null; spans must be null:
// csrc/ragged_spans_f16.cu takes them).
// block_q * (nq / kvh) must fit the instance's rows, as rpa_tc_launch's.
extern "C" int rpa_tc_f16_launch(int dtype, int kv_dtype, const void* q,
                                 const void* cache_layer, void* out,
                                 const int* item_req,
                                 const int* item_qstart,
                                 const int* item_qlen, const int* item_pos,
                                 const int* seq_lens,
                                 const int* block_tables, int num_items,
                                 int max_pages, int nq, int kvh,
                                 int page_size, int hd, int block_q,
                                 float scale, int sliding_window,
                                 int chunk_attn, float soft_cap,
                                 const float* alibi, const int* spans,
                                 int num_spans, void* stream) {
  return rpa_tc_dispatch<false, __half>(
      dtype, kv_dtype, q, cache_layer, out, item_req, item_qstart,
      item_qlen, item_pos, seq_lens, block_tables, num_items, max_pages, nq,
      kvh, page_size, hd, block_q, scale, sliding_window, chunk_attn,
      soft_cap, alibi, spans, num_spans, static_cast<cudaStream_t>(stream));
}
