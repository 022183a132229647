// The MLA geometry of the ragged and window attention kernels on the
// tensor cores (CUDA, sm_90a): bf16 queries of any group on one KV head of
// head_dim 576.
//
// Replaces the MLA geometry of the TPU kernels `ragged_paged_attention` /
// `_rpa_kernel` (aphrodite_tpu/ops/ragged_paged_attention.py) and
// `window_decode_attention` / `_wd_kernel`
// (aphrodite_tpu/ops/window_decode_attention.py), which the JAX package's
// DeepSeek V2/V3 runs as MQA over one latent head (models/deepseek.py:
// K = [c_kv, k_pe], V = [c_kv, 0], 512 + 64 = 576 lanes; the JAX runner
// shrinks block_q for it, worker/runner.py:216-245). They compute what the
// other instances compute (csrc/ragged_paged_attention.cu,
// csrc/window_decode_attention.cu): causal attention with the optional soft
// cap (a template switch), sliding window and chunked local attention (a
// mask), fully masked rows 0. V is read as the cache holds it: the kernels
// assume neither its zero lanes nor its equality to K.
//
// What the geometry forces. At head_dim 576 a warp's fp32 O fragment for
// 16 rows is 16 x 576 / 32 = 288 registers a thread, more than a thread
// has (255), so O's columns are split across warps that share one P through
// shared memory (not across blocks, which would each recompute S: 1.5x
// the products). Each warp computes S for its own keys of the tile over all
// 576 dims, the warps exchange their row maxima and their P fragments
// (bf16, the A operand of P V) in shared memory, and each accumulates P V
// for its own columns over all the tile's keys. The softmax state (m, l)
// is then the same in every warp: m is the max of the exchanged maxima and
// each warp's l is the sum over its own keys, added up at the end. The
// cost: two barriers a tile and 4.5 KB of exchange; every mma is done once.
//
// mla_ragged_kernel (B1's MLA instance). A block is 8 warps and 64 query
// rows (the item's tokens times the group, token-major), four row tiles of
// 16; warps w and w + 4 own row tile w % 4, split the tile's 32 keys into
// halves for S and O's 576 columns into halves of 288 for P V (36 n-tiles,
// 144 registers). Q (64 rows) and a 2-stage cp.async ring of 32-key K and V
// tiles, rows padded to 584 bf16, take 224,256 bytes, the exchange 4,608:
// one block an SM. A token's rows may exceed the block's (V3: 128 query
// heads on one KV head): grid.z cuts the item's rows into slices of 64.
//
// mla_window_kernel (B2's MLA instance): the window's split-KV scheme
// (csrc/window_decode_attention.cu: the same 64-key plan tiles, splits,
// cascade start and merge), each plan tile walked as two 32-key tiles. A
// block is 4 warps and one 16-row tile of the group (grid.y: KV head x row
// tile, so any group launches); warp w takes keys 8w..8w+7 of a tile for S
// and O's columns 144w..144w+143 for P V. 16 query rows and the ring take
// 168,192 bytes. Each block writes its split's unnormalized state and
// mla_merge_kernel adds the init state (the cascade's) and the splits in a
// fixed order (csrc/split_decode.cuh merge_row).
//
// Bound. DeepSeek-V2-Lite's wave (32 x 512 tokens, 16 heads) moves ~0.64 GB
// (q and out 302 MB each, K/V 38 MB): >= 0.19 ms; its products are 155
// GFLOP, >= 0.16 ms at the bf16 peak. A window sub-step at R = 32 reads
// ~40 MB of K/V: >= 0.012 ms. mma.sync reaches well below the card's bf16
// rate and each K/V fragment serves 16 rows; wgmma with TMA and a producer
// warp (FlashMLA's shape) is later work.
#include "split_decode.cuh"

namespace {

using namespace mma;
using bf16 = __nv_bfloat16;

constexpr int kHD = 576;
constexpr int kP = kHD + 8;       // bf16 a staged row: 8 rows of an ldmatrix
                                  // land in 8 distinct bank groups
constexpr int kCPR = kHD / 8;     // 16-byte copies a row
constexpr int kKeys = 32;         // keys a tile
constexpr float kLog2e = 1.4426950408889634f;

// A barrier of `threads` threads under the id `id` (0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------ ragged
namespace rg {
constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int kRows = 64;               // query rows a block
constexpr int kCols = kHD / 2;          // O columns a warp
constexpr int kNT = kCols / 8;          // O n-tiles a warp
constexpr int kRing = (kRows + 2 * 2 * kKeys) * kP * 2;
constexpr int kSmem = kRing + kWarps * 32 * 16 + kWarps * 16 * 4;
}  // namespace rg

template <bool kCap>
__global__ void __launch_bounds__(rg::kThreads, 1)
mla_ragged_kernel(const bf16* __restrict__ q, const bf16* __restrict__ cache,
                  bf16* __restrict__ out, const int* __restrict__ item_req,
                  const int* __restrict__ item_qstart,
                  const int* __restrict__ item_qlen,
                  const int* __restrict__ item_pos,
                  const int* __restrict__ seq_lens,
                  const int* __restrict__ block_tables, int max_pages,
                  int nq, int kvh, int page_size, float scale,
                  int sliding_window, int chunk_attn, float soft_cap) {
  using namespace attn;
  using namespace rg;
  const int item = blockIdx.x, h = blockIdx.y;
  const int group = nq / kvh;
  const int req = item_req[item], qstart = item_qstart[item];
  const int qlen = item_qlen[item], pos0 = item_pos[item];
  const int row_lo = blockIdx.z * kRows;  // this slice's first item row
  const int rows = min(kRows, qlen * group - row_lo);
  if (rows <= 0) return;  // block-uniform
  const int kv_limit = min(pos0 + qlen, seq_lens[req]);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int rt = warp & 3, half = warp >> 2, partner = warp ^ 4;
  const int* bt = block_tables + (size_t)req * max_pages;
  const size_t page_elems = (size_t)page_size * kHD;
  const int page_shift = __popc(page_size) == 1 ? __ffs(page_size) - 1 : -1;
  const float mult = (kCap ? 1.f : scale) * kLog2e;
  const float cap_scale = kCap ? scale / soft_cap : 0.f;

  extern __shared__ uint4 smem_mla[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_mla);  // [kRows, kP]
  bf16* kv_s = q_s + kRows * kP;                  // [2][K, V][kKeys, kP]
  uint4* px = reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(smem_mla) +
                                       kRing);   // [kWarps][32] P fragments
  float* mx = reinterpret_cast<float*>(px + kWarps * 32);  // [kWarps][16]

  // Q: block row r is item row row_lo + r = token t, query head g.
#pragma unroll 2
  for (int k = 0; k < kRows * kCPR / kThreads; ++k) {
    const int i = tid + k * kThreads;
    const int r = i / kCPR, c = i - r * kCPR;
    const bool ok = r < rows;
    const bf16* src = q;
    if (ok) {
      const int R = row_lo + r, t = R / group, g = R - t * group;
      src = q + ((size_t)(qstart + t) * nq + h * group + g) * kHD + c * 8;
    }
    cp_async16(q_s + r * kP + c * 8, src, ok);
  }
  // K/V tile t into ring stage `stage`; keys at or past kv_limit are zero.
  auto load_tile = [&](int t, int stage) {
    bf16* ks = kv_s + (size_t)stage * 2 * kKeys * kP;
#pragma unroll
    for (int k = 0; k < kKeys * kCPR / kThreads; ++k) {
      const int i = tid + k * kThreads;
      const int j = i / kCPR, c = i - j * kCPR;
      const int pos = t * kKeys + j;
      const bool ok = pos < kv_limit;
      const bf16* src = cache;
      if (ok) {
        const int pg = page_shift >= 0 ? pos >> page_shift : pos / page_size;
        src = cache + ((size_t)bt[pg] * 2 * kvh + h) * page_elems +
              (size_t)(pos - pg * page_size) * kHD + c * 8;
      }
      cp_async16(ks + j * kP + c * 8, src, ok);
      cp_async16(ks + (kKeys + j) * kP + c * 8,
                 ok ? src + kvh * page_elems : src, ok);
    }
  };

  // This lane's rows g and g + 8 of the warp's row tile, their positions;
  // rows past the block take the last token's (never stored).
  const int last = qlen - 1;
  const int w_row = rt * 16;
  int qp[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    qp[hf] = pos0 + min((row_lo + w_row + hf * 8 + gq) / group, last);
  const bool warp_live = w_row < rows;
  const int w_lo = pos0 + min((row_lo + w_row) / group, last);
  const int w_hi = pos0 + min((row_lo + w_row + 15) / group, last);
  const int w_first = first_visible(w_lo, sliding_window, chunk_attn);
  const int t_lo =
      first_visible(pos0 + row_lo / group, sliding_window, chunk_attn) /
      kKeys;
  const int n_tiles = (kv_limit - 1) / kKeys - t_lo + 1;

  float o[kNT][4];
#pragma unroll
  for (int d = 0; d < kNT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const bf16* q_w = q_s + (w_row + (lane & 15)) * kP + (lane >> 4) * 8;
  const int k_off =
      (half * 16 + (lane & 7) + ((lane >> 4) << 3)) * kP + ((lane >> 3) & 1) * 8;
  const int v_off = (lane & 15) * kP + (lane >> 4) * 8 + half * kCols;

  if (n_tiles > 0) load_tile(t_lo, 0);
  cp_async_commit();  // with Q
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();  // tile it has landed
    __syncthreads();     // and tile it - 1 is consumed
    if (it + 1 < n_tiles) load_tile(t_lo + it + 1, (it + 1) & 1);
    cp_async_commit();
    const int kv0 = (t_lo + it) * kKeys;
    // Both warps of a row tile take the same branch here.
    if (!warp_live || kv0 > w_hi || kv0 + kKeys <= w_first) continue;
    const bf16* ks = kv_s + (size_t)(it & 1) * 2 * kKeys * kP;
    const bf16* vs = ks + kKeys * kP;

    // S = Q K^T for the row tile and this warp's 16 keys.
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kc = 0; kc < kHD / 16; ++kc) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, q_w + kc * 16);
      ldmatrix_x4(b, ks + k_off + kc * 16);
      mma_bf16(s[0], a, b);
      mma_bf16(s[1], a, b + 2);
    }
    if constexpr (kCap) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = soft_cap * tanhf(s[j][e] * cap_scale);
    }
    const bool full =
        kv0 + kKeys - 1 <= w_lo &&
        (sliding_window <= 0 || kv0 > w_hi - sliding_window) &&
        (chunk_attn <= 0 ||
         (kv0 / chunk_attn == (kv0 + kKeys - 1) / chunk_attn &&
          kv0 / chunk_attn == w_lo / chunk_attn &&
          w_lo / chunk_attn == w_hi / chunk_attn));
    if (!full) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kv = kv0 + half * 16 + j * 8 + 2 * tq + (e & 1);
          const int qpos = qp[e >> 1];
          if (kv > qpos || !local_ok(kv, qpos, sliding_window, chunk_attn))
            s[j][e] = -INFINITY;
        }
    }

    // Row maxima over the tile's 32 keys: this warp's 16, then its
    // partner's through shared memory (fmaxf commutes: both warps agree).
    float mx_a = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    float mx_b = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
    }
    if (tq == 0) {
      mx[warp * 16 + gq] = mx_a;
      mx[warp * 16 + gq + 8] = mx_b;
    }
    named_sync(1 + rt, 64);
    mx_a = fmaxf(mx_a, mx[partner * 16 + gq]);
    mx_b = fmaxf(mx_b, mx[partner * 16 + gq + 8]);
    const float mn_a = fmaxf(m_r[0], mx_a), mn_b = fmaxf(m_r[1], mx_b);
    // A row with no visible key yet keeps m = -inf: p = 0, alpha = 0.
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a * mult;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b * mult;
    const float al_a = fast_exp2(m_r[0] * mult - base_a);
    const float al_b = fast_exp2(m_r[1] * mult - base_b);
    m_r[0] = mn_a;
    m_r[1] = mn_b;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j][0] = fast_exp2(fmaf(s[j][0], mult, -base_a));
      s[j][1] = fast_exp2(fmaf(s[j][1], mult, -base_a));
      s[j][2] = fast_exp2(fmaf(s[j][2], mult, -base_b));
      s[j][3] = fast_exp2(fmaf(s[j][3], mult, -base_b));
    }
    l_r[0] = l_r[0] * al_a + s[0][0] + s[0][1] + s[1][0] + s[1][1];
    l_r[1] = l_r[1] * al_b + s[0][2] + s[0][3] + s[1][2] + s[1][3];
#pragma unroll
    for (int d = 0; d < kNT; ++d) {
      o[d][0] *= al_a;
      o[d][1] *= al_a;
      o[d][2] *= al_b;
      o[d][3] *= al_b;
    }
    // P's A fragments: this warp's 16 keys are k-step `half` of P V.
    const uint4 mine = make_uint4(pack_bf16(s[0][0], s[0][1]),
                                  pack_bf16(s[0][2], s[0][3]),
                                  pack_bf16(s[1][0], s[1][1]),
                                  pack_bf16(s[1][2], s[1][3]));
    px[warp * 32 + lane] = mine;
    named_sync(1 + rt, 64);
    const uint4 theirs = px[partner * 32 + lane];
    const uint4 p0 = half ? theirs : mine, p1 = half ? mine : theirs;
    const uint32_t a0[4] = {p0.x, p0.y, p0.z, p0.w};
    const uint32_t a1[4] = {p1.x, p1.y, p1.z, p1.w};

    // O[:, my columns] += P V over the tile's 32 keys.
#pragma unroll
    for (int dp = 0; dp < kNT / 2; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + dp * 16 + v_off);
      mma_bf16(o[2 * dp], a0, b);
      mma_bf16(o[2 * dp + 1], a0, b + 2);
      ldmatrix_x4_trans(b, vs + 16 * kP + dp * 16 + v_off);
      mma_bf16(o[2 * dp], a1, b);
      mma_bf16(o[2 * dp + 1], a1, b + 2);
    }
  }
  cp_async_wait<0>();
  if (!warp_live) return;  // both warps of the row tile

  // l: this warp's keys, then its partner's (the row maxima are read).
  float l_a = l_r[0], l_b = l_r[1];
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o_);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o_);
  }
  if (tq == 0) {
    mx[warp * 16 + gq] = l_a;
    mx[warp * 16 + gq + 8] = l_b;
  }
  named_sync(1 + rt, 64);
  l_a += mx[partner * 16 + gq];
  l_b += mx[partner * 16 + gq + 8];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = w_row + hf * 8 + gq;
    if (row >= rows) continue;
    const float inv = 1.f / fmaxf(hf ? l_b : l_a, 1e-20f);
    const int R = row_lo + row, t = R / group, g = R - t * group;
    bf16* dst = out + ((size_t)(qstart + t) * nq + h * group + g) * kHD +
                half * kCols + 2 * tq;
#pragma unroll
    for (int d = 0; d < kNT; ++d)
      *reinterpret_cast<uint32_t*>(dst + d * 8) =
          pack_bf16(o[d][2 * hf] * inv, o[d][2 * hf + 1] * inv);
  }
}

// ------------------------------------------------------------------ window
namespace wd {
constexpr int kWarps = 4, kThreads = kWarps * 32;
constexpr int kRows = 16;               // query rows a block
constexpr int kCols = kHD / kWarps;     // O columns a warp
constexpr int kNT = kCols / 8;          // O n-tiles a warp
constexpr int kPlanKeys = 64;           // keys a tile of the host's plan
constexpr int kRing = (kRows + 2 * 2 * kKeys) * kP * 2;
constexpr int kSmem = kRing + kWarps * 32 * 8 + kWarps * 16 * 4;
}  // namespace wd

template <bool kCap>
__global__ void __launch_bounds__(wd::kThreads, 1)
mla_window_kernel(const bf16* __restrict__ q, const bf16* __restrict__ cache,
                  const bf16* __restrict__ tail_k,
                  const bf16* __restrict__ tail_v,
                  float* __restrict__ part_acc, float* __restrict__ part_m,
                  float* __restrict__ part_l,
                  const int* __restrict__ paged_lens,
                  const int* __restrict__ block_tables, int max_pages, int nq,
                  int kvh, int page_size, int kw, int step, float scale,
                  int sliding_window, int chunk_attn, float soft_cap,
                  int shared_len, int tiles_per_split) {
  using namespace attn;
  using namespace wd;
  const int group = nq / kvh, row_tiles = (group + kRows - 1) / kRows;
  const int r = blockIdx.x, h = blockIdx.y / row_tiles;
  const int g0 = (blockIdx.y - h * row_tiles) * kRows;
  const int nrows = min(kRows, group - g0);
  const int split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int plen = paged_lens[r], q_pos = plen + step;
  // The request's 64-key plan tiles (window_decode_attention.cu
  // request_tiles): page tiles from the one holding its first visible
  // position lo (>= shared_len), then tail tiles.
  int lo = first_visible(q_pos, sliding_window, chunk_attn);
  lo = min(max(lo, shared_len), plen);
  const int t0 = lo / kPlanKeys;
  const int n_paged = (plen + kPlanKeys - 1) / kPlanKeys - t0;
  const int n_tiles = n_paged + (step + kPlanKeys) / kPlanKeys;
  const int ta = split * tiles_per_split;
  const int n_sub =
      2 * split::my_tiles(n_tiles, ta, tiles_per_split, split, splits);
  const int* bt = block_tables + (size_t)r * max_pages;
  const size_t page_elems = (size_t)page_size * kHD;
  const size_t tail_base = ((size_t)r * kvh + h) * kw * kHD;
  const int page_shift = __popc(page_size) == 1 ? __ffs(page_size) - 1 : -1;
  const size_t row0 = (size_t)r * nq + h * group + g0;
  const float mult = (kCap ? 1.f : scale) * kLog2e;
  const float cap_scale = kCap ? scale / soft_cap : 0.f;

  extern __shared__ uint4 smem_mla[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_mla);  // [kRows, kP]
  bf16* kv_s = q_s + kRows * kP;                  // [2][K, V][kKeys, kP]
  uint2* px = reinterpret_cast<uint2*>(reinterpret_cast<uint8_t*>(smem_mla) +
                                       kRing);   // [kWarps][32]
  float* mx = reinterpret_cast<float*>(px + kWarps * 32);  // [kWarps][16]

  // Key j of sub-tile u (the half u & 1 of plan tile ta + u / 2): a page
  // position or a tail slot; `paged` says which.
  auto key_of = [&](int u, int j, bool* paged) {
    const int t = ta + (u >> 1);
    *paged = t < n_paged;
    return (*paged ? (t0 + t) * kPlanKeys : (t - n_paged) * kPlanKeys) +
           (u & 1) * kKeys + j;
  };
  for (int i = tid; i < kRows * kCPR; i += kThreads) {
    const int g = i / kCPR, c = i - g * kCPR;
    const bool ok = g < nrows;
    cp_async16(q_s + g * kP + c * 8, ok ? q + (row0 + g) * kHD + c * 8 : q,
               ok);
  }
  // Sub-tile u into stage `stage`; keys hidden by position are not read.
  auto load_tile = [&](int u, int stage) {
    bf16* ks = kv_s + (size_t)stage * 2 * kKeys * kP;
#pragma unroll 3
    for (int k = 0; k < kKeys * kCPR / kThreads; ++k) {
      const int i = tid + k * kThreads;
      const int j = i / kCPR, c = i - j * kCPR;
      bool paged;
      const int key = key_of(u, j, &paged);
      const bf16 *ksrc = q, *vsrc = q;
      bool ok;
      if (paged) {
        ok = key >= lo && key < plen;
        if (ok) {
          const int pg = page_shift >= 0 ? key >> page_shift : key / page_size;
          ksrc = cache + ((size_t)bt[pg] * 2 * kvh + h) * page_elems +
                 (size_t)(key - pg * page_size) * kHD + c * 8;
          vsrc = ksrc + kvh * page_elems;
        }
      } else {
        ok = key <= step;
        if (ok) {
          ksrc = tail_k + tail_base + (size_t)key * kHD + c * 8;
          vsrc = tail_v + tail_base + (size_t)key * kHD + c * 8;
        }
      }
      cp_async16(ks + j * kP + c * 8, ksrc, ok);
      cp_async16(ks + (kKeys + j) * kP + c * 8, vsrc, ok);
    }
  };

  float o[kNT][4];
#pragma unroll
  for (int d = 0; d < kNT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const bf16* q_w = q_s + (lane & 15) * kP + (lane >> 4) * 8;
  // B of S: keys 8w + (lane & 7), dims of two k-steps, 8 a matrix.
  const int k_off = (warp * 8 + (lane & 7)) * kP + (lane >> 3) * 8;
  const int v_off = (lane & 15) * kP + (lane >> 4) * 8 + warp * kCols;

  if (n_sub > 0) load_tile(0, 0);
  cp_async_commit();  // with Q
  for (int u = 0; u < n_sub; ++u) {
    cp_async_wait<0>();  // sub-tile u has landed
    __syncthreads();     // and sub-tile u - 1 is consumed
    if (u + 1 < n_sub) load_tile(u + 1, (u + 1) & 1);
    cp_async_commit();
    const bf16* ks = kv_s + (size_t)(u & 1) * 2 * kKeys * kP;
    const bf16* vs = ks + kKeys * kP;

    // S for the 16 rows and this warp's 8 keys.
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k2 = 0; k2 < kHD / 32; ++k2) {
      uint32_t a[4], b[4];
      ldmatrix_x4(b, ks + k_off + k2 * 32);
      ldmatrix_x4(a, q_w + k2 * 32);
      mma_bf16(s, a, b);
      ldmatrix_x4(a, q_w + k2 * 32 + 16);
      mma_bf16(s, a, b + 2);
    }
    if constexpr (kCap) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = soft_cap * tanhf(s[e] * cap_scale);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bool paged;
      const int key = key_of(u, warp * 8 + 2 * tq + e, &paged);
      const bool vis =
          paged ? key >= lo && key < plen &&
                      local_ok(key, q_pos, sliding_window, chunk_attn)
                : key <= step &&
                      local_ok(plen + key, q_pos, sliding_window, chunk_attn);
      if (!vis) s[e] = s[e + 2] = -INFINITY;
    }

    // Row maxima over the tile's keys: every warp reads the four partial
    // maxima in the same order, so all agree.
    float mx_a = fmaxf(s[0], s[1]), mx_b = fmaxf(s[2], s[3]);
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
    }
    if (tq == 0) {
      mx[warp * 16 + gq] = mx_a;
      mx[warp * 16 + gq + 8] = mx_b;
    }
    __syncthreads();
    mx_a = fmaxf(fmaxf(mx[gq], mx[16 + gq]), fmaxf(mx[32 + gq], mx[48 + gq]));
    mx_b = fmaxf(fmaxf(mx[gq + 8], mx[24 + gq]),
                 fmaxf(mx[40 + gq], mx[56 + gq]));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a * mult;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b * mult;
    const float al_a = fast_exp2(m_a * mult - base_a);
    const float al_b = fast_exp2(m_b * mult - base_b);
    m_a = mn_a;
    m_b = mn_b;
    s[0] = fast_exp2(fmaf(s[0], mult, -base_a));
    s[1] = fast_exp2(fmaf(s[1], mult, -base_a));
    s[2] = fast_exp2(fmaf(s[2], mult, -base_b));
    s[3] = fast_exp2(fmaf(s[3], mult, -base_b));
    l_a = l_a * al_a + s[0] + s[1];
    l_b = l_b * al_b + s[2] + s[3];
#pragma unroll
    for (int d = 0; d < kNT; ++d) {
      o[d][0] *= al_a;
      o[d][1] *= al_a;
      o[d][2] *= al_b;
      o[d][3] *= al_b;
    }
    // This warp's keys are n-tile `warp` of P: half of k-step warp / 2's
    // A fragment (a0, a1 from even warps, a2, a3 from odd ones).
    px[warp * 32 + lane] =
        make_uint2(pack_bf16(s[0], s[1]), pack_bf16(s[2], s[3]));
    __syncthreads();
    uint32_t a[2][4];
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      const uint2 lo2 = px[(2 * kc) * 32 + lane];
      const uint2 hi2 = px[(2 * kc + 1) * 32 + lane];
      a[kc][0] = lo2.x;
      a[kc][1] = lo2.y;
      a[kc][2] = hi2.x;
      a[kc][3] = hi2.y;
    }

    // O[:, my columns] += P V over the tile's 32 keys.
#pragma unroll
    for (int dp = 0; dp < kNT / 2; ++dp) {
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + kc * 16 * kP + dp * 16 + v_off);
        mma_bf16(o[2 * dp], a[kc], b);
        mma_bf16(o[2 * dp + 1], a[kc], b + 2);
      }
    }
  }
  cp_async_wait<0>();

  // l: each warp's keys, summed in warp order (the same in every warp).
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o_);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o_);
  }
  __syncthreads();  // the last tile's maxima are read
  if (tq == 0) {
    mx[warp * 16 + gq] = l_a;
    mx[warp * 16 + gq + 8] = l_b;
  }
  __syncthreads();
  // The split's unnormalized state: acc for this warp's columns, m (in the
  // scaled logit's units) and l by warp 0.
  const float to_scaled = mult * 0.6931471805599453f;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int g = gq + hf * 8;
    if (g >= nrows) continue;
    const size_t row = row0 + g;
    float* dst = part_acc + (row * splits + split) * kHD + warp * kCols + 2 * tq;
#pragma unroll
    for (int d = 0; d < kNT; ++d) {
      dst[d * 8] = o[d][2 * hf];
      dst[d * 8 + 1] = o[d][2 * hf + 1];
    }
    if (warp == 0 && tq == 0) {
      part_m[row * splits + split] = (hf ? m_b : m_a) * to_scaled;
      part_l[row * splits + split] =
          ((mx[g] + mx[16 + g]) + mx[32 + g]) + mx[48 + g];
    }
  }
}

// One block a query row (r * nq + query head): split::merge_row.
template <bool kCascade>
__global__ void __launch_bounds__(128)
mla_merge_kernel(const float* __restrict__ part_acc,
                 const float* __restrict__ part_m,
                 const float* __restrict__ part_l, bf16* __restrict__ out,
                 const float* __restrict__ acc0, const float* __restrict__ m0,
                 const float* __restrict__ l0, int splits) {
  split::merge_row<bf16, kCascade>(blockIdx.x, part_acc, part_m, part_l, out,
                                   acc0, m0, l0, kHD, splits);
}

template <bool kCap>
int ragged(const void* q, const void* cache, void* out, const int* item_req,
           const int* item_qstart, const int* item_qlen, const int* item_pos,
           const int* seq_lens, const int* block_tables, int num_items,
           int max_pages, int nq, int kvh, int page_size, int slices,
           float scale, int sliding_window, int chunk_attn, float soft_cap,
           cudaStream_t stream) {
  const cudaError_t err = allow_smem<mla_ragged_kernel<kCap>>(rg::kSmem);
  if (err != cudaSuccess) return (int)err;
  mla_ragged_kernel<kCap>
      <<<dim3(num_items, kvh, slices), rg::kThreads, rg::kSmem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(cache),
          static_cast<bf16*>(out), item_req, item_qstart, item_qlen,
          item_pos, seq_lens, block_tables, max_pages, nq, kvh, page_size,
          scale, sliding_window, chunk_attn, soft_cap);
  return (int)cudaGetLastError();
}

template <bool kCap>
int window_split(const void* q, const void* cache, const void* tail_k,
                 const void* tail_v, float* part_acc, float* part_m,
                 float* part_l, const int* paged_lens,
                 const int* block_tables, int num_reqs, int max_pages, int nq,
                 int kvh, int page_size, int kw, int step, float scale,
                 int sliding_window, int chunk_attn, float soft_cap,
                 int shared_len, int splits, int tiles_per_split,
                 cudaStream_t stream) {
  const cudaError_t err = allow_smem<mla_window_kernel<kCap>>(wd::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (nq / kvh + wd::kRows - 1) / wd::kRows;
  mla_window_kernel<kCap><<<dim3(num_reqs, kvh * row_tiles, splits),
                            wd::kThreads, wd::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(cache),
      static_cast<const bf16*>(tail_k), static_cast<const bf16*>(tail_v),
      part_acc, part_m, part_l, paged_lens, block_tables, max_pages, nq, kvh,
      page_size, kw, step, scale, sliding_window, chunk_attn, soft_cap,
      shared_len, tiles_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// The ragged kernel's MLA instance: bf16 q [T, nq, 576] and cache layer
// [P, 2, kvh, page, 576]; block_q tokens a work item, whose block_q * (nq /
// kvh) rows are cut into slices of 64 (grid.z).
extern "C" int mla_ragged_launch(const void* q, const void* cache_layer,
                                 void* out, const int* item_req,
                                 const int* item_qstart,
                                 const int* item_qlen, const int* item_pos,
                                 const int* seq_lens,
                                 const int* block_tables, int num_items,
                                 int max_pages, int nq, int kvh,
                                 int page_size, int block_q, float scale,
                                 int sliding_window, int chunk_attn,
                                 float soft_cap, void* stream) {
  if (kvh <= 0 || nq % kvh || block_q <= 0 || num_items <= 0)
    return (int)cudaErrorInvalidValue;
  const int slices = (block_q * (nq / kvh) + rg::kRows - 1) / rg::kRows;
  auto s = static_cast<cudaStream_t>(stream);
  return (soft_cap > 0.f ? ragged<true> : ragged<false>)(
      q, cache_layer, out, item_req, item_qstart, item_qlen, item_pos,
      seq_lens, block_tables, num_items, max_pages, nq, kvh, page_size,
      slices, scale, sliding_window, chunk_attn, soft_cap, s);
}

// The window kernel's MLA instance, then its merge, on `stream`: bf16 q
// [R, nq, 576], cache layer and tails [R, kvh, kw, 576] in bf16.
// part_acc [R, nq, splits, 576], part_m and part_l [R, nq, splits] fp32
// scratch; acc0 [R, nq, 576], m0 and l0 [R, nq]: the cascade's init state
// covering page positions < shared_len, or all three null.
extern "C" int mla_window_launch(
    const void* q, const void* cache_layer, const void* tail_k_layer,
    const void* tail_v_layer, void* out, float* part_acc, float* part_m,
    float* part_l, const int* paged_lens, const int* block_tables,
    int num_reqs, int max_pages, int nq, int kvh, int page_size, int kw,
    int step, float scale, int sliding_window, int chunk_attn,
    float soft_cap, const float* acc0, const float* m0, const float* l0,
    int shared_len, int splits, int tiles_per_split, void* stream) {
  if ((acc0 == nullptr) != (m0 == nullptr) ||
      (acc0 == nullptr) != (l0 == nullptr) || shared_len < 0 ||
      (acc0 == nullptr && shared_len != 0) || kvh <= 0 || nq % kvh ||
      splits < 1 || tiles_per_split < 1 || num_reqs <= 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  int err = (soft_cap > 0.f ? window_split<true> : window_split<false>)(
      q, cache_layer, tail_k_layer, tail_v_layer, part_acc, part_m, part_l,
      paged_lens, block_tables, num_reqs, max_pages, nq, kvh, page_size, kw,
      step, scale, sliding_window, chunk_attn, soft_cap, shared_len, splits,
      tiles_per_split, s);
  if (err != 0) return err;
  const dim3 grid(num_reqs * nq);
  if (acc0 != nullptr)
    mla_merge_kernel<true><<<grid, 128, 0, s>>>(
        part_acc, part_m, part_l, static_cast<bf16*>(out), acc0, m0, l0,
        splits);
  else
    mla_merge_kernel<false><<<grid, 128, 0, s>>>(
        part_acc, part_m, part_l, static_cast<bf16*>(out), nullptr, nullptr,
        nullptr, splits);
  return (int)cudaGetLastError();
}
