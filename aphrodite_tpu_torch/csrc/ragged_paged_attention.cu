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
// ~69 GFLOP: bound by bytes, >= 0.10 ms.
//
// rpa_tc_kernel (bf16 at head_dim 64, 128 and 256): FlashAttention-2 on
// mma.sync m16n8k16 (bf16 in, fp32 accumulate). A block is 4 warps and
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
// reads K with ldmatrix, PV takes P in registers (rounded to bf16) as the
// A operand and V through ldmatrix.trans. The online softmax (m, l) lives
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
// An fp8 cache (e4m3fn or e5m2, the template type KV): the TPU kernel
// upcasts each K/V tile to q's dtype before both products (:194-196), and
// so do these. The tensor-core instance stages the tile's bytes by 16-byte
// cp.async (16 keys' values a copy: half the bytes of a bf16 tile) into a
// ring of its own, converts them once into the bf16 tile that ldmatrix
// reads (attn::convert_rows, one more barrier a tile), and runs the same
// products; the scalar one converts to fp32 as it stages. Bound: the K/V
// bytes halve.
//
// rpa_kernel (fp32, and bf16 at other head dims): the first version, kept
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
#include "attn_common.cuh"
#include "mma_common.cuh"

namespace {

// ------------------------------------ scalar kernel (fp32; other head dims)
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
           const float* __restrict__ alibi) {
  using namespace attn;
  const int item = blockIdx.x, h = blockIdx.y;
  const int group = nq / kvh;
  const int req = item_req[item], qstart = item_qstart[item];
  const int qlen = item_qlen[item], pos0 = item_pos[item];
  // This block's slice of the item's rows: [row_lo, row_lo + rows).
  const int row_lo = blockIdx.z * block_rows, rows_max = block_rows;
  const int rows = min(block_rows, qlen * group - row_lo);
  if (rows <= 0) return;  // block-uniform
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
      if (kv0 > q_pos) continue;  // whole tile in this row's future
      const int kv_pos = kv0 + lane;
      const bool valid = lane < n && kv_pos <= q_pos &&
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
           float soft_cap, const float* alibi, int smem_bytes,
           cudaStream_t stream) {
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
      scale, sliding_window, chunk_attn, soft_cap, alibi);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- tensor-core kernel (bf16)
// 4 warps; each owns kMT 16-row m-tiles (2 at head_dim <= 128: the B
// fragments of K and V serve both; 1 at 256, where O alone is 128
// registers a thread). Two blocks fit an SM's registers and shared memory.
// An fp8 cache adds a ring of staged bytes.
template <int HD, typename KV>
struct TcCfg {
  static constexpr int kMT = HD <= 128 ? 2 : 1;       // m-tiles a warp
  static constexpr int kWarps = 4;
  static constexpr int kThreads = kWarps * 32;  // 128: __launch_bounds__
  static constexpr int kRows = kWarps * 16 * kMT;     // query rows a block
  static constexpr int kKeys = HD <= 128 ? 64 : 32;   // keys a tile
  static constexpr int kPitch = HD + 8;               // bf16 a staged row
  static constexpr int kStages = HD <= 64 ? 3 : 2;
  static constexpr int kRing = (kRows + kStages * 2 * kKeys) * kPitch * 2;
  static constexpr int kStaged =
      attn::is_fp8<KV> ? kStages * 2 * kKeys * HD : 0;
  static constexpr int kSmem = kRing + kStaged;
};

template <int HD, bool kCap, bool kAlibi, typename KV>
__global__ void __launch_bounds__(128, 2)
rpa_tc_kernel(const __nv_bfloat16* __restrict__ q,
              const KV* __restrict__ cache,
              __nv_bfloat16* __restrict__ out,
              const int* __restrict__ item_req,
              const int* __restrict__ item_qstart,
              const int* __restrict__ item_qlen,
              const int* __restrict__ item_pos,
              const int* __restrict__ seq_lens,
              const int* __restrict__ block_tables, int max_pages, int nq,
              int kvh, int page_size, float scale, int sliding_window,
              int chunk_attn, float soft_cap,
              const float* __restrict__ alibi) {
  using namespace attn;
  using namespace mma;
  using C = TcCfg<HD, KV>;
  constexpr bool kFp8 = is_fp8<KV>;
  constexpr int BN = C::kKeys, P = C::kPitch, CPR = HD / 8, MT = C::kMT;
  // 16-byte copies a K (or V) row takes: 8 bf16 or 16 fp8 values each.
  constexpr int KCPR = kFp8 ? HD / 16 : CPR;
  constexpr int NT = BN / 8, DT = HD / 8;  // n-tiles of S and of O
  const int item = blockIdx.x, h = blockIdx.y;
  const int group = nq / kvh;
  const int req = item_req[item], qstart = item_qstart[item];
  const int qlen = item_qlen[item], pos0 = item_pos[item];
  const int rows = qlen * group;
  const int kv_limit = min(pos0 + qlen, seq_lens[req]);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int* bt = block_tables + (size_t)req * max_pages;
  const size_t page_elems = (size_t)page_size * HD;
  const int page_shift = __popc(page_size) == 1 ? __ffs(page_size) - 1 : -1;
  // Softmax units: the raw logit q.k without a cap (scale folded into the
  // exponent), the capped scaled logit with one.
  const float mult = (kCap ? 1.f : scale) * 1.4426950408889634f;
  const float cap_scale = kCap ? scale / soft_cap : 0.f;

  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // [rows, P]
  __nv_bfloat16* kv_s = q_s + C::kRows * P;  // [stages][K, V][BN, P]
  // fp8: [stages][K, V][BN, HD] bytes, converted into kv_s's stage.
  uint8_t* stg = reinterpret_cast<uint8_t*>(smem_tc) + C::kRing;

  // Q, row r = token r / group, query head h * group + r % group; rows
  // past the item are zero.
#pragma unroll 4
  for (int k = 0; k < C::kRows * CPR / C::kThreads; ++k) {
    const int i = tid + k * C::kThreads;
    const int r = i / CPR, c = i - r * CPR;
    const bool ok = r < rows;
    const __nv_bfloat16* src = q;
    if (ok) {
      const int t = r / group, g = r - t * group;
      src = q + ((size_t)(qstart + t) * nq + h * group + g) * HD + c * 8;
    }
    cp_async16(q_s + r * P + c * 8, src, ok);
  }
  // K/V tile t (keys t * BN ...) into ring stage `stage` (fp8: its
  // staged bytes), each thread finding its key rows' pages; keys at or
  // past kv_limit are zero. Copy c of a row is its bytes [16 c, 16 c + 16).
  auto load_tile = [&](int t, int stage) {
    __nv_bfloat16* ks = kv_s + (size_t)stage * 2 * BN * P;
    uint8_t* kb = stg + (size_t)stage * 2 * BN * HD;
#pragma unroll
    for (int k = 0; k < BN * KCPR / C::kThreads; ++k) {
      const int i = tid + k * C::kThreads;
      const int j = i / KCPR, c = i - j * KCPR;
      const int pos = t * BN + j;
      const bool ok = pos < kv_limit;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(cache);
      if (ok) {
        const int pg = page_shift >= 0 ? pos >> page_shift : pos / page_size;
        src += (((size_t)bt[pg] * 2 * kvh + h) * page_elems +
                (size_t)(pos - pg * page_size) * HD) * sizeof(KV) + c * 16;
      }
      const uint8_t* vsrc = ok ? src + kvh * page_elems * sizeof(KV) : src;
      if constexpr (kFp8) {
        cp_async16(kb + j * HD + c * 16, src, ok);
        cp_async16(kb + (BN + j) * HD + c * 16, vsrc, ok);
      } else {
        cp_async16(ks + j * P + c * 8, src, ok);
        cp_async16(ks + (BN + j) * P + c * 8, vsrc, ok);
      }
    }
  };

  // This lane's rows: g and g + 8 of each of the warp's m-tiles, and their
  // positions; rows past the item take the last token's position (never
  // stored).
  const int last = qlen - 1;
  const int w_row = warp * 16 * MT;
  int qp[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      qp[mt][hf] = pos0 + min((w_row + mt * 16 + hf * 8 + gq) / group, last);
  // ALiBi: each row's slope over the scale (raw-logit units), read once,
  // and its position as a float.
  [[maybe_unused]] float sl[MT][2], qpf[MT][2];
  if constexpr (kAlibi) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        sl[mt][hf] =
            alibi[h * group + (w_row + mt * 16 + hf * 8 + gq) % group] /
            scale;
        qpf[mt][hf] = (float)qp[mt][hf];
      }
  }
  const bool warp_live = w_row < rows;
  const int w_lo = pos0 + min(w_row / group, last);
  const int w_hi = pos0 + min((w_row + 16 * MT - 1) / group, last);
  const int w_first = first_visible(w_lo, sliding_window, chunk_attn);
  const int t_lo = first_visible(pos0, sliding_window, chunk_attn) / BN;
  const int n_tiles = (kv_limit - 1) / BN - t_lo + 1;

  float o[MT][DT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][d][e] = 0.f;
  float m_r[MT][2], l_r[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_r[mt][0] = m_r[mt][1] = -INFINITY;
    l_r[mt][0] = l_r[mt][1] = 0.f;
  }
  // ldmatrix addresses: A (Q rows) and B of K (row-major) and V (.trans).
  const __nv_bfloat16* q_w = q_s + (w_row + (lane & 15)) * P + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8;
  const int v_off = (lane & 15) * P + (lane >> 4) * 8;

#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < n_tiles) load_tile(t_lo + s, s);
    cp_async_commit();  // group 0 holds Q too
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<C::kStages - 2>();  // tile it has landed
    __syncthreads();                  // and tile it - 1 is consumed
    if constexpr (kFp8)  // its bytes into the stage's bf16 tile
      convert_rows<KV, HD>(stg + (size_t)(it % C::kStages) * 2 * BN * HD,
                           kv_s + (size_t)(it % C::kStages) * 2 * BN * P,
                           2 * BN, P, tid, C::kThreads);
    {
      const int nx = it + C::kStages - 1;
      if (nx < n_tiles) load_tile(t_lo + nx, nx % C::kStages);
      cp_async_commit();
    }
    if constexpr (kFp8) __syncthreads();  // the converted tile is whole
    const int kv0 = (t_lo + it) * BN;
    if (!warp_live || kv0 > w_hi || kv0 + BN <= w_first) continue;
    const __nv_bfloat16* ks = kv_s + (size_t)(it % C::kStages) * 2 * BN * P;
    const __nv_bfloat16* vs = ks + BN * P;

    // S = Q K^T for the warp's rows and the tile's keys.
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], q_w + mt * 16 * P + kc * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + np * 16 * P + kc * 16 + k_off);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], b);
          mma_bf16(s[mt][2 * np + 1], a[mt], b + 2);
        }
      }
    }

    // ALiBi, the soft cap (on the scaled logit), then the mask where some
    // key is hidden from some row of the warp: switches and uniform
    // branches around whole loops, so that no lane issues what its tile
    // does not need.
    if constexpr (kAlibi) {
      const float kf = (float)(kv0 + 2 * tq);  // this lane's first key
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float d0 = kf - qpf[mt][hf];
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              s[mt][j][2 * hf + e] =
                  fmaf(sl[mt][hf], d0 + (float)(j * 8 + e),
                       s[mt][j][2 * hf + e]);
        }
    }
    if constexpr (kCap) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][j][e] = soft_cap * tanhf(s[mt][j][e] * cap_scale);
    }
    const bool full =
        kv0 + BN - 1 <= w_lo &&
        (sliding_window <= 0 || kv0 > w_hi - sliding_window) &&
        (chunk_attn <= 0 || (kv0 / chunk_attn == (kv0 + BN - 1) / chunk_attn &&
                             kv0 / chunk_attn == w_lo / chunk_attn &&
                             w_lo / chunk_attn == w_hi / chunk_attn));
    if (!full) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kv = kv0 + j * 8 + 2 * tq + (e & 1);
            const int qpos = qp[mt][e >> 1];
            if (kv > qpos || !local_ok(kv, qpos, sliding_window, chunk_attn))
              s[mt][j][e] = -INFINITY;
          }
    }

    // Online softmax of each row (a lane quad holds one row's keys): c0,
    // c1 are row g, c2, c3 row g + 8. m is kept in logit units; the
    // exponents are base 2 with the scale folded in (mult).
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * hf], s[mt][j][2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m_r[mt][hf], mx);
        // A row with no visible key yet keeps m = -inf: exponents from 0
        // give p = 0 and alpha = 0, never NaN.
        const float base = mn == -INFINITY ? 0.f : mn * mult;
        const float alpha = fast_exp2(m_r[mt][hf] * mult - base);
        m_r[mt][hf] = mn;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          s[mt][j][2 * hf] = fast_exp2(fmaf(s[mt][j][2 * hf], mult, -base));
          s[mt][j][2 * hf + 1] =
              fast_exp2(fmaf(s[mt][j][2 * hf + 1], mult, -base));
          rs += s[mt][j][2 * hf] + s[mt][j][2 * hf + 1];
        }
        l_r[mt][hf] = l_r[mt][hf] * alpha + rs;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          o[mt][d][2 * hf] *= alpha;
          o[mt][d][2 * hf + 1] *= alpha;
        }
      }

    // O += P V: P's accumulators are the A fragments of 16-key chunks.
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kc][0], s[mt][2 * kc][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kc][2], s[mt][2 * kc][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kc + 1][0], s[mt][2 * kc + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kc + 1][2], s[mt][2 * kc + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + kc * 16 * P + dp * 16 + v_off);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * dp], a[mt], b);
          mma_bf16(o[mt][2 * dp + 1], a[mt], b + 2);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!warp_live) return;

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float l = l_r[mt][hf];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = w_row + mt * 16 + hf * 8 + gq;
      if (row >= rows) continue;
      const float inv = 1.f / fmaxf(l, 1e-20f);
      const int t = row / group, g = row - t * group;
      __nv_bfloat16* dst =
          out + ((size_t)(qstart + t) * nq + h * group + g) * HD + 2 * tq;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<uint32_t*>(dst + d * 8) =
            pack_bf16(o[mt][d][2 * hf] * inv, o[mt][d][2 * hf + 1] * inv);
    }
}

template <int HD, bool kCap, bool kAlibi, typename KV>
int launch_tc(const void* q, const void* cache, void* out,
              const int* item_req, const int* item_qstart,
              const int* item_qlen, const int* item_pos, const int* seq_lens,
              const int* block_tables, int num_items, int max_pages, int nq,
              int kvh, int page_size, float scale, int sliding_window,
              int chunk_attn, float soft_cap, const float* alibi,
              cudaStream_t stream) {
  using C = TcCfg<HD, KV>;
  const cudaError_t err =
      mma::allow_smem<rpa_tc_kernel<HD, kCap, kAlibi, KV>>(C::kSmem);
  if (err != cudaSuccess) return (int)err;
  rpa_tc_kernel<HD, kCap, kAlibi, KV>
      <<<dim3(num_items, kvh), C::kThreads, C::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(cache),
      static_cast<__nv_bfloat16*>(out), item_req, item_qstart, item_qlen,
      item_pos, seq_lens, block_tables, max_pages, nq, kvh, page_size, scale,
      sliding_window, chunk_attn, soft_cap, alibi);
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
              float soft_cap, const float* alibi, int smem_bytes,
              cudaStream_t s) {
#define RPA_KV(KV)                                                          \
  return launch<T, KV>(q, cache_layer, out, item_req, item_qstart,          \
                       item_qlen, item_pos, seq_lens, block_tables,         \
                       num_items, max_pages, nq, kvh, page_size, hd,        \
                       block_q, block_rows, scale, sliding_window,          \
                       chunk_attn, soft_cap, alibi, smem_bytes, s)
  if (kv_dtype == kKvAuto) RPA_KV(T);
  if (kv_dtype == kKvE4M3) RPA_KV(__nv_fp8_e4m3);
  if (kv_dtype == kKvE5M2) RPA_KV(__nv_fp8_e5m2);
#undef RPA_KV
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The scalar kernel (fp32 or bf16 q, any head_dim; the cache in q's dtype
// or fp8, kv_dtype a KvDtype code; alibi [nq] fp32 slopes or null). A work
// item's block_q * (nq / kvh) rows are cut into slices of block_rows, one
// block each (grid.z), so that a group larger than a block's rows (MLA's
// 128 query heads on one KV head) launches
// (ops/ragged_paged_attention.py ragged_block_rows).
extern "C" int rpa_launch(int dtype, int kv_dtype, const void* q,
                          const void* cache_layer, void* out,
                          const int* item_req, const int* item_qstart,
                          const int* item_qlen, const int* item_pos,
                          const int* seq_lens, const int* block_tables,
                          int num_items, int max_pages, int nq, int kvh,
                          int page_size, int hd, int block_q, int block_rows,
                          float scale, int sliding_window, int chunk_attn,
                          float soft_cap, const float* alibi, int smem_bytes,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (kvh <= 0 || nq % kvh || block_q <= 0 || block_rows <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch_kv<float>(kv_dtype, q, cache_layer, out, item_req,
                            item_qstart, item_qlen, item_pos, seq_lens,
                            block_tables, num_items, max_pages, nq, kvh,
                            page_size, hd, block_q, block_rows, scale,
                            sliding_window, chunk_attn, soft_cap, alibi,
                            smem_bytes, s);
  if (dtype == kBFloat16)
    return launch_kv<__nv_bfloat16>(kv_dtype, q, cache_layer, out, item_req,
                                    item_qstart, item_qlen, item_pos,
                                    seq_lens, block_tables, num_items,
                                    max_pages, nq, kvh, page_size, hd,
                                    block_q, block_rows, scale,
                                    sliding_window, chunk_attn, soft_cap,
                                    alibi, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernel (bf16 q, head_dim 64, 128 or 256; the cache bf16
// or fp8, kv_dtype a KvDtype code; alibi [nq] fp32 slopes or null).
// block_q * (nq / kvh) must fit the
// instance's rows (128 at head_dim <= 128, 64 at 256:
// ops/ragged_paged_attention.py ragged_tc_block_q).
extern "C" int rpa_tc_launch(int kv_dtype, const void* q,
                             const void* cache_layer,
                             void* out, const int* item_req,
                             const int* item_qstart, const int* item_qlen,
                             const int* item_pos, const int* seq_lens,
                             const int* block_tables, int num_items,
                             int max_pages, int nq, int kvh, int page_size,
                             int hd, int block_q, float scale,
                             int sliding_window, int chunk_attn,
                             float soft_cap, const float* alibi,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (kvh <= 0 || nq % kvh || block_q <= 0)
    return (int)cudaErrorInvalidValue;
  const int rows = block_q * (nq / kvh);
  const bool cap = soft_cap > 0.f, ali = alibi != nullptr;
#define RPA_TC(HD, KV)                                                      \
  if (hd == HD) {                                                           \
    if (rows > TcCfg<HD, KV>::kRows) return (int)cudaErrorInvalidValue;     \
    return (cap ? (ali ? launch_tc<HD, true, true, KV>                      \
                       : launch_tc<HD, true, false, KV>)                    \
                : (ali ? launch_tc<HD, false, true, KV>                     \
                       : launch_tc<HD, false, false, KV>))(                 \
        q, cache_layer, out, item_req, item_qstart, item_qlen, item_pos,    \
        seq_lens, block_tables, num_items, max_pages, nq, kvh, page_size,   \
        scale, sliding_window, chunk_attn, soft_cap, alibi, s);             \
  }
#define RPA_TC_KV(KV) \
  RPA_TC(64, KV)      \
  RPA_TC(128, KV)     \
  RPA_TC(256, KV)     \
  return (int)cudaErrorInvalidValue;
  if (kv_dtype == kKvAuto) {
    RPA_TC_KV(__nv_bfloat16)
  }
  if (kv_dtype == kKvE4M3) {
    RPA_TC_KV(__nv_fp8_e4m3)
  }
  if (kv_dtype == kKvE5M2) {
    RPA_TC_KV(__nv_fp8_e5m2)
  }
#undef RPA_TC_KV
#undef RPA_TC
  return (int)cudaErrorInvalidValue;
}
