// Ragged paged attention for prefill and mixed waves (CUDA, sm_90a).
//
// Replaces the TPU kernel `ragged_paged_attention` / `_rpa_kernel` of
// aphrodite_tpu/ops/ragged_paged_attention.py. It computes the same
// function: causal attention of a ragged batch of query tokens
// q [T, nq, hd] over each request's KV pages, read through block_tables
// from one layer of the cache [P, 2, kvh, page, hd], with optional sliding
// window, chunked local attention, ALiBi and logit soft cap: the bias
// slope[h * group + g] * (kv_pos - q_pos) on the scaled logit, then
// cap * tanh(s / cap), then the mask, in the TPU kernel's order (:201-216).
// Fully masked rows give 0 (acc / max(l, 1e-20)), never NaN.
//
// Work items. The host cuts each request's scheduled tokens into items of
// up to block_q tokens. One block runs one (item, KV head): its rows are
// the item's tokens times the group of query heads sharing that KV head,
// packed token-major, so one read of a K/V tile serves the whole group.
// Output goes straight to the flat [T, nq, hd] layout.
//
// Bound. Phase 14's wave (128 requests x 128 new tokens over 1152-token
// contexts, 32 / 8 heads of 128) is ~292 GFLOP of QK^T and PV against
// ~0.87 GB of q, K/V and output: bound by operations, >= 0.30 ms at the
// bf16 tensor-core peak. The 8B wave (32 x 512) is ~0.34 GB against
// ~69 GFLOP: bound by bytes, >= 0.10 ms. BLOOM-3b's wave (32 x 512, 32 /
// 32 heads of 80, ALiBi) moves ~0.34 GB (q 84 MB, K/V 168 MB, output
// 84 MB) against ~43 GFLOP: bound by bytes, >= 0.10 ms, as the 8B wave.
//
// rpa_tc_kernel (bf16 and fp16 at any head_dim that is a multiple of 16
// up to 256: BLOOM's 80 and 96, MPT-30B's 112, tiny models' 32 and 48):
// FlashAttention-2 on mma.sync m16n8k16 (bf16 or fp16 in, fp32
// accumulate; the element type T a template parameter, so one source
// serves both). The instances are built at three tile widths HD (64, 128
// and 256); a head_dim hd runs in the narrowest that holds it. hd is a
// run-time argument: q, the cache and the output stride by it, and the
// 16-byte copies of Q, K and V past a row's hd columns are zero-filled
// (cp.async with no source bytes), so the products over the padded columns
// add zeros and the store leaves them out. The padding costs no bytes of
// device memory; it costs shared memory, O's registers and the padded
// columns' products (hd 80 in a 128-wide tile: 60 % more mma than the
// head needs; the wave stays bound by bytes). Uniform branches that
// skipped the padded k-steps and n-tiles instead (one source, no padded
// products) cost the instances at 64, 128 and 256 4-30 % of their device
// time (chip_smoke.py --ab, PERF.md): the loops keep their compile-time
// bounds, so ptxas schedules the ldmatrix loads across k-steps as before;
// the strides and the copies' tests still cost the 64- and 128-wide
// instances 1-2 %. No instance was added (each instance set costs the parallel build
// 15-35 s, PERF.md); a multiple of 16 because an fp8 row stages 16 values
// a 16-byte copy and a k-step takes 16. A block is 4 warps and
// two blocks share an SM, so that one block's loads and barriers overlap
// the other's products. At head_dim <= 128 each warp owns 32 rows (two
// 16-row m-tiles, so every K and V fragment read from shared memory
// serves two mma) and a block 128 rows; at 256 a warp owns 16 rows and a
// block 64 (the fp32 O fragment alone is 128 registers a thread there). A
// partial last row tile is masked, not padded in memory. Q is staged once
// by cp.async and its A fragments re-read with ldmatrix for every tile
// (kept in registers they would leave no room for the second block). K
// and V tiles (64 keys; 32 at head_dim 256) are staged in bf16 by 16-byte
// cp.async in a ring of 2 stages (3 at head_dim 64), each thread finding
// its key row's page through the block table, so a tile may span pages
// of 16, 32 or 64 tokens. Rows are padded by 8 bf16 (16 bytes) so that
// the 8 rows an ldmatrix reads fall in 8 distinct bank groups. S = Q K^T
// reads K with ldmatrix, PV takes P in registers (rounded to q's dtype, as
// the TPU kernel rounds P to V's, :225-227) as the A operand and V through
// ldmatrix.trans. The online softmax (m, l) lives
// in registers, reduced across the lane quad by shuffles, with base-2
// exponents and the scale folded into one FFMA. The soft cap is a
// template switch and the mask a uniform branch around its loop, applied
// only on tiles where some key is hidden from some row of the warp (the
// causal diagonal, the window or chunk edge, the partial last tile): as
// per-element branches they cost more than both products. A warp skips
// tiles wholly in its rows' future or before their window or chunk, and
// the block starts at the item's first visible tile.
//
// ALiBi (slopes: [nq] fp32, or null) is a template switch of the
// tensor-core instance, as the soft cap is: as a uniform branch on the
// pointer it cost the instances without ALiBi 4-5 % (its registers and
// code in their main loop), and those serve every other path. The scalar
// instance takes it as that uniform branch. Positions are absolute (the
// row's token_pos, the key's index), so a chunk of a prompt sees the keys
// of earlier chunks at their distances. The scalar instance adds the bias
// to the scaled logit (tile_update). The tensor-core instance reads a
// row's slope once, divided by the scale, and adds slope/scale * (kv -
// q_pos) to the raw logit q.k (the distance a float add of small integers,
// exact; one FMA a score), so both folds stay as they are: without a cap
// exp2((s + slope/scale * d) * scale * log2e) = exp2((s * scale + slope *
// d) * log2e); with one cap * tanh((s + slope/scale * d) * scale/cap) =
// cap * tanh((s * scale + slope * d) / cap). It costs ~10 % at phase 22's
// wave (PERF.md): one FMA a score with the row's constant taken out of
// the loop cost as much, and reading the slope each tile cost more.
//
// Bidirectional image spans (spans: int32 [R, M, 2], (lo, hi) per image
// and -1 padding, or null: Gemma-3 multimodal): a row and a key that lie
// in one span [lo, hi) of the row's request see each other in either
// order, so the mask is (causal OR inside one span) AND kv < seq_len, then
// the window and the chunk, as the TPU kernel masks (:173-184). A key past
// the row is visible only through a span that holds the row; the spans
// that hold one position overlap in it, so their union is one interval,
// and each row keeps that interval [s_lo, s_hi) (empty where no span holds
// it). A block scans keys up to the end of the spans that meet its rows
// (at most seq_len), where the TPU kernel scans every item to seq_len
// (kv_limit_of, :75-82): an item of a text row in the same launch loads no
// more than its causal keys. The tensor-core instance takes spans as a
// template switch (kSpans), as ALiBi, and widens each warp's skip of tiles
// in its rows' future to the end of its rows' spans; the masked branch
// tests (causal OR span) per element, and the full-tile test is kept
// (spans only add visible keys). The scalar instance takes them as a
// uniform branch on the pointer. The span instances take ALiBi beside
// spans (the bias on every visible key, those past the row through a span
// too, as the TPU kernel adds it) as a uniform branch on the slopes'
// pointer: as a third switch it doubled their count and added 35 s to the
// parallel build (PERF.md). The tensor-core kernel is in
// csrc/ragged_tc.cuh; its span instances are built in csrc/ragged_spans.cu
// (bf16) and csrc/ragged_spans_f16.cu (fp16), beside this file's, so that
// the parts compile in parallel. The MLA instance takes spans and ALiBi
// in instances of its own (csrc/mla_attention.cuh, kOpts).
//
// An fp8 cache (e4m3fn or e5m2, the template type KV): the TPU kernel
// upcasts each K/V tile to q's dtype before both products (:194-196), and
// so do these. The tensor-core instance stages the tile's bytes by 16-byte
// cp.async (16 keys' values a copy: half the bytes of a bf16 tile) into a
// ring of its own, converts them once into the tile of q's dtype that
// ldmatrix reads (attn::convert_rows, one more barrier a tile: under fp16
// one cvt a pair of values, under bf16 three steps), and runs the same
// products; the scalar one converts to fp32 as it stages. Bound: the K/V
// bytes halve.
//
// fp16 queries (an fp16 model): the same tensor-core instances with
// T = __half, their products f32.f16.f16.f32 (the TPU kernel computes in
// q's dtype with fp32 accumulation, :194-200), built in a translation unit
// of their own (csrc/ragged_f16.cu, entry rpa_tc_f16_launch) so that nvcc
// compiles them beside the bf16 ones; the fp16 span instances are in
// csrc/ragged_spans_f16.cu. The MLA geometry is csrc/mla_attention.cuh's.
// The scalar instance takes __half as one more type, where bf16 would go
// there too.
//
// rpa_kernel (fp32, and bf16 or fp16 at a head_dim that is not a
// multiple of 16, or past 256 but MLA's 576): the first version, kept
// so that the fp32 parity paths stay exact (tensor cores would take fp32
// through TF32): rows in shared memory as float, 32-key tiles staged by
// all threads, one warp a row, lane j owning key j. Where one token's group
// of rows does not fit a block (MLA: 128 query heads at head_dim 576 would
// need 739,456 bytes), grid.z cuts the item's rows into slices.
// The MLA geometry in bf16 (head_dim 576) runs csrc/mla_attention.cu.
//
// What holds it back (PERF.md): at the 8B wave the loads and barriers
// alone take ~60 % of its time, at phase 14 ~half: every 128-row item
// copies all of its request's keys from L2 into shared memory. Left for
// later: wgmma with TMA loads and a producer warp (mma.sync tops out well
// below the card's bf16 rate), larger items or clusters that share K/V
// tiles, and 16-byte output stores through shared memory.
#include "ragged_tc.cuh"

namespace {

// -------- scalar kernel (fp32; bf16 / fp16 at head dims not a multiple of 16)
constexpr int kWarps = 8;

template <typename T, typename KV>
__global__ void __launch_bounds__(kWarps * 32)
rpa_kernel(const T* __restrict__ q, const KV* __restrict__ cache,
           T* __restrict__ out, const int* __restrict__ item_req,
           const int* __restrict__ item_qstart,
           const int* __restrict__ item_qlen,
           const int* __restrict__ item_pos,
           const int* __restrict__ seq_lens,
           const int* __restrict__ block_tables, int max_pages, int nq,
           int kvh, int page_size, int hd, int block_rows, float scale,
           int sliding_window, int chunk_attn, float soft_cap,
           const float* __restrict__ alibi, const int* __restrict__ spans,
           int num_spans) {
  using namespace attn;
  const int item = blockIdx.x, h = blockIdx.y;
  const int group = nq / kvh;
  const int req = item_req[item], qstart = item_qstart[item];
  const int qlen = item_qlen[item], pos0 = item_pos[item];
  // This block's slice of the item's rows: [row_lo, row_lo + rows).
  const int row_lo = blockIdx.z * block_rows, rows_max = block_rows;
  const int rows = min(block_rows, qlen * group - row_lo);
  if (rows <= 0) return;  // block-uniform
  const int* sp =
      spans != nullptr ? spans + (size_t)req * num_spans * 2 : nullptr;
  const int kv_limit =
      spans != nullptr
          ? span_kv_limit(sp, num_spans, pos0, qlen, seq_lens[req])
          : min(pos0 + qlen, seq_lens[req]);
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

  // Block row r is item row R = row_lo + r = token t * group + g, which
  // reads query head h * group + g.
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const int R = row_lo + r, t = R / group, g = R - t * group;
    q_s[i] = to_float(q[((size_t)(qstart + t) * nq + h * group + g) * hd + d]);
    acc_s[i] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  const size_t page_elems = (size_t)page_size * hd;
  const int lo =
      first_visible(pos0 + row_lo / group, sliding_window, chunk_attn);
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
      const int q_pos = pos0 + (row_lo + r) / group;
      int s_lo = 0, s_hi = -1;  // the keys its spans add: none
      if (spans != nullptr) row_span(sp, num_spans, q_pos, s_lo, s_hi);
      // whole tile in this row's future and past its spans
      if (kv0 > max(q_pos, s_hi - 1)) continue;
      const int kv_pos = kv0 + lane;
      const bool valid =
          lane < n && (kv_pos <= q_pos || (kv_pos >= s_lo && kv_pos < s_hi)) &&
          local_ok(kv_pos, q_pos, sliding_window, chunk_attn);
      const float bias = alibi != nullptr
                             ? alibi[h * group + (row_lo + r) % group] *
                                   (float)(kv_pos - q_pos)
                             : 0.f;
      tile_update(q_s + (size_t)r * hd, k_s, v_s, n, hd, valid, scale,
                  soft_cap, acc_s + (size_t)r * hd, m_s + r, l_s + r,
                  p_s + warp * kTile, lane, bias);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const int R = row_lo + r, t = R / group, g = R - t * group;
    out[((size_t)(qstart + t) * nq + h * group + g) * hd + d] =
        from_float<T>(acc_s[i] / fmaxf(l_s[r], 1e-20f));
  }
}

template <typename T, typename KV>
int launch(const void* q, const void* cache, void* out, const int* item_req,
           const int* item_qstart, const int* item_qlen, const int* item_pos,
           const int* seq_lens, const int* block_tables, int num_items,
           int max_pages, int nq, int kvh, int page_size, int hd, int block_q,
           int block_rows, float scale, int sliding_window, int chunk_attn,
           float soft_cap, const float* alibi, const int* spans,
           int num_spans, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rpa_kernel<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int slices = (block_q * (nq / kvh) + block_rows - 1) / block_rows;
  rpa_kernel<T, KV><<<dim3(num_items, kvh, slices), kWarps * 32, smem_bytes,
                      stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(cache),
      static_cast<T*>(out), item_req, item_qstart, item_qlen, item_pos,
      seq_lens, block_tables, max_pages, nq, kvh, page_size, hd, block_rows,
      scale, sliding_window, chunk_attn, soft_cap, alibi, spans, num_spans);
  return (int)cudaGetLastError();
}

// The scalar kernel on a cache in q's dtype or fp8 (a KvDtype code).
template <typename T>
int launch_kv(int kv_dtype, const void* q, const void* cache_layer,
              void* out, const int* item_req, const int* item_qstart,
              const int* item_qlen, const int* item_pos, const int* seq_lens,
              const int* block_tables, int num_items, int max_pages, int nq,
              int kvh, int page_size, int hd, int block_q, int block_rows,
              float scale, int sliding_window, int chunk_attn,
              float soft_cap, const float* alibi, const int* spans,
              int num_spans, int smem_bytes, cudaStream_t s) {
#define RPA_KV(KV)                                                          \
  return launch<T, KV>(q, cache_layer, out, item_req, item_qstart,          \
                       item_qlen, item_pos, seq_lens, block_tables,         \
                       num_items, max_pages, nq, kvh, page_size, hd,        \
                       block_q, block_rows, scale, sliding_window,          \
                       chunk_attn, soft_cap, alibi, spans, num_spans,       \
                       smem_bytes, s)
  if (kv_dtype == kKvAuto) RPA_KV(T);
  if (kv_dtype == kKvE4M3) RPA_KV(__nv_fp8_e4m3);
  if (kv_dtype == kKvE5M2) RPA_KV(__nv_fp8_e5m2);
#undef RPA_KV
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The scalar kernel (fp32, bf16 or fp16 q, any head_dim: the wrapper sends it
// fp32, and bf16 / fp16 only at a head_dim that is not a multiple of 16; the
// cache in q's dtype or fp8, kv_dtype a KvDtype code; alibi [nq] fp32 slopes or
// null; spans int32 [R, num_spans, 2] image spans or null). A work item's
// block_q * (nq / kvh) rows are cut into slices of block_rows, one block each
// (grid.z), so that a group larger than a block's rows (MLA's 128 query heads
// on one KV head) launches (ops/ragged_paged_attention.py ragged_block_rows).
extern "C" int rpa_launch(int dtype, int kv_dtype, const void* q,
                          const void* cache_layer, void* out,
                          const int* item_req, const int* item_qstart,
                          const int* item_qlen, const int* item_pos,
                          const int* seq_lens, const int* block_tables,
                          int num_items, int max_pages, int nq, int kvh,
                          int page_size, int hd, int block_q, int block_rows,
                          float scale, int sliding_window, int chunk_attn,
                          float soft_cap, const float* alibi,
                          const int* spans, int num_spans, int smem_bytes,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (kvh <= 0 || nq % kvh || block_q <= 0 || block_rows <= 0 ||
      (spans != nullptr && num_spans <= 0))
    return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch_kv<float>(kv_dtype, q, cache_layer, out, item_req,
                            item_qstart, item_qlen, item_pos, seq_lens,
                            block_tables, num_items, max_pages, nq, kvh,
                            page_size, hd, block_q, block_rows, scale,
                            sliding_window, chunk_attn, soft_cap, alibi,
                            spans, num_spans, smem_bytes, s);
  if (dtype == kBFloat16)
    return launch_kv<__nv_bfloat16>(kv_dtype, q, cache_layer, out, item_req,
                                    item_qstart, item_qlen, item_pos,
                                    seq_lens, block_tables, num_items,
                                    max_pages, nq, kvh, page_size, hd,
                                    block_q, block_rows, scale,
                                    sliding_window, chunk_attn, soft_cap,
                                    alibi, spans, num_spans, smem_bytes, s);
  if (dtype == kFloat16)
    return launch_kv<__half>(kv_dtype, q, cache_layer, out, item_req,
                             item_qstart, item_qlen, item_pos, seq_lens,
                             block_tables, num_items, max_pages, nq, kvh,
                             page_size, hd, block_q, block_rows, scale,
                             sliding_window, chunk_attn, soft_cap, alibi,
                             spans, num_spans, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 tensor-core kernel without image spans (dtype must be
// kBFloat16: csrc/ragged_f16.cu takes fp16; head_dim a multiple of 16 up
// to 256, in tiles 64, 128 or 256 wide; the
// cache bf16 or fp8, kv_dtype a KvDtype code; alibi [nq] fp32 slopes or
// null; spans must be null: csrc/ragged_spans.cu takes them). block_q *
// (nq / kvh) must fit the instance's rows (128 at head_dim <= 128, 64
// past it: ops/ragged_paged_attention.py ragged_tc_block_q).
extern "C" int rpa_tc_launch(int dtype, int kv_dtype, const void* q,
                             const void* cache_layer, void* out,
                             const int* item_req, const int* item_qstart,
                             const int* item_qlen, const int* item_pos,
                             const int* seq_lens, const int* block_tables,
                             int num_items, int max_pages, int nq, int kvh,
                             int page_size, int hd, int block_q, float scale,
                             int sliding_window, int chunk_attn,
                             float soft_cap, const float* alibi,
                             const int* spans, int num_spans, void* stream) {
  return rpa_tc_dispatch<false, __nv_bfloat16>(
      dtype, kv_dtype, q, cache_layer, out, item_req, item_qstart, item_qlen,
      item_pos, seq_lens, block_tables, num_items, max_pages, nq, kvh,
      page_size, hd, block_q, scale, sliding_window, chunk_attn, soft_cap,
      alibi, spans, num_spans, static_cast<cudaStream_t>(stream));
}
