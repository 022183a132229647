// The MLA instances of the ragged and window attention kernels for bf16
// queries (CUDA, sm_90a). csrc/mla_attention.cuh describes the kernel,
// whose query type T is a template parameter; the fp16 instances are built
// in csrc/mla_attention_f16.cu, a translation unit of its own, so that
// nvcc compiles the two sets side by side.
#include "mla_attention.cuh"

// Entry points (ctypes); each returns a cudaError_t.
//
// mla_ragged_launch: the ragged kernel's MLA instance for bf16 q (q_code
// 1) on a bf16 or fp8 cache (kv_code 0, or e4m3fn 1, e5m2 2); the
// arguments as ragged_entry's.
extern "C" int mla_ragged_launch(int q_code, int kv_code, const void* q,
                                 const void* cache_layer, void* out,
                                 const int* item_req,
                                 const int* item_qstart,
                                 const int* item_qlen, const int* item_pos,
                                 const int* seq_lens,
                                 const int* block_tables, int num_items,
                                 int max_pages, int num_pages, int nq,
                                 int kvh, int page_size, int block_q,
                                 float scale, int sliding_window,
                                 int chunk_attn, float soft_cap,
                                 void* stream) {
  return ragged_entry<bf16>(q_code, kv_code, q, cache_layer, out, item_req,
                            item_qstart, item_qlen, item_pos, seq_lens,
                            block_tables, num_items, max_pages, num_pages,
                            nq, kvh, page_size, block_q, scale,
                            sliding_window, chunk_attn, soft_cap, stream);
}

// mla_window_launch: the window kernel's MLA instance and its merge for
// bf16 q (q_code 1); the arguments as window_entry's.
extern "C" int mla_window_launch(
    int q_code, int kv_code, const void* q, const void* cache_layer,
    const void* tail_k_layer, const void* tail_v_layer, void* out,
    float* part_acc, float* part_m, float* part_l, const int* paged_lens,
    const int* block_tables, int num_reqs, int max_pages, int num_pages,
    int nq, int kvh, int page_size, int kw, int step, float scale,
    int sliding_window, int chunk_attn, float soft_cap, const float* acc0,
    const float* m0, const float* l0, int shared_len, int splits,
    int tiles_per_split, void* stream) {
  return window_entry<bf16>(
      q_code, kv_code, q, cache_layer, tail_k_layer, tail_v_layer, out,
      part_acc, part_m, part_l, paged_lens, block_tables, num_reqs,
      max_pages, num_pages, nq, kvh, page_size, kw, step, scale,
      sliding_window, chunk_attn, soft_cap, acc0, m0, l0, shared_len, splits,
      tiles_per_split, stream);
}
