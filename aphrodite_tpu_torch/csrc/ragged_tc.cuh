// The ragged kernel's tensor-core instance (rpa_tc_kernel, bf16 and fp16
// at any head_dim that is a multiple of 16 up to 256, in tiles 64, 128 or
// 256 wide), shared by the four translation units that
// instantiate it: csrc/ragged_paged_attention.cu (bf16 without spans; the
// scalar instance too), csrc/ragged_f16.cu (fp16 without spans),
// csrc/ragged_spans.cu and csrc/ragged_spans_f16.cu (the bf16 and fp16
// span instances, kSpans, which take ALiBi too), built side by side so
// that none holds the whole set of instances. The span helpers are in
// csrc/attn_common.cuh. csrc/ragged_paged_attention.cu describes the
// kernels.
#pragma once

#include "attn_common.cuh"
#include "mma_common.cuh"

namespace {

// ------------------------------------------ tensor-core kernel (bf16, fp16)
// 4 warps; each owns kMT 16-row m-tiles (2 at head_dim <= 128: the B
// fragments of K and V serve both; 1 at 256, where O alone is 128
// registers a thread). Two blocks fit an SM's registers and shared memory.
// An fp8 cache adds a ring of staged bytes. HD is the tiles' width; the
// model's head_dim hd (a multiple of 16, at most HD) is a run-time
// argument, and every global address strides by it.
template <int HD, typename KV>
struct TcCfg {
  static constexpr int kMT = HD <= 128 ? 2 : 1;       // m-tiles a warp
  static constexpr int kWarps = 4;
  static constexpr int kThreads = kWarps * 32;  // 128: __launch_bounds__
  static constexpr int kRows = kWarps * 16 * kMT;     // query rows a block
  static constexpr int kKeys = HD <= 128 ? 64 : 32;   // keys a tile
  static constexpr int kPitch = HD + 8;               // 16-bit elements a row
  static constexpr int kStages = HD <= 64 ? 3 : 2;
  static constexpr int kRing = (kRows + kStages * 2 * kKeys) * kPitch * 2;
  static constexpr int kStaged =
      attn::is_fp8<KV> ? kStages * 2 * kKeys * HD : 0;
  static constexpr int kSmem = kRing + kStaged;
};

// T: q's and the output's element type (__nv_bfloat16 or __half), which
// the products take; K/V in T or fp8 (KV), converted to T in shared memory.
// ALiBi is a template switch (kAlibi) of the instances without spans and a
// uniform branch on the slopes' pointer in the span instances (kSpans,
// kAlibi false), as in the scalar instance: a switch there doubled their
// count and phase 1's build of csrc/ragged_spans.cu (PERF.md).
template <typename T, int HD, bool kCap, bool kAlibi, bool kSpans,
          typename KV>
__global__ void __launch_bounds__(128, 2)
rpa_tc_kernel(const T* __restrict__ q,
              const KV* __restrict__ cache,
              T* __restrict__ out,
              const int* __restrict__ item_req,
              const int* __restrict__ item_qstart,
              const int* __restrict__ item_qlen,
              const int* __restrict__ item_pos,
              const int* __restrict__ seq_lens,
              const int* __restrict__ block_tables, int max_pages, int nq,
              int kvh, int page_size, int hd, float scale,
              int sliding_window,
              int chunk_attn, float soft_cap,
              const float* __restrict__ alibi,
              const int* __restrict__ spans, int num_spans) {
  using namespace attn;
  using namespace mma;
  using C = TcCfg<HD, KV>;
  constexpr bool kFp8 = is_fp8<KV>;
  constexpr int BN = C::kKeys, P = C::kPitch, CPR = HD / 8, MT = C::kMT;
  // 16-byte copies a K (or V) row takes: 8 16-bit or 16 fp8 values each.
  constexpr int KCPR = kFp8 ? HD / 16 : CPR;
  constexpr int NT = BN / 8, DT = HD / 8;  // n-tiles of S and of O
  // The 16-byte copies of a row past the model's hd columns are
  // zero-filled (Q, K and V alike, so the products over the padded columns
  // add zeros) and the output's padded columns are not stored. The loops
  // keep their compile-time bounds; what hd adds to an instance at
  // hd == HD is its strides and these tests, 1-2 % of its device time at
  // widths 64 and 128 and ~0 at 256 (PERF.md). A row's offset in its page
  // is multiplied in 32 bits (it is below page_size * hd).
  constexpr int kCopyElems = kFp8 ? 16 : 8;  // values a K/V copy moves
  const int item = blockIdx.x, h = blockIdx.y;
  const int group = nq / kvh;
  const int req = item_req[item], qstart = item_qstart[item];
  const int qlen = item_qlen[item], pos0 = item_pos[item];
  const int rows = qlen * group;
  [[maybe_unused]] const int* sp =
      kSpans ? spans + (size_t)req * num_spans * 2 : nullptr;
  const int kv_limit =
      kSpans ? span_kv_limit(sp, num_spans, pos0, qlen, seq_lens[req])
             : min(pos0 + qlen, seq_lens[req]);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int* bt = block_tables + (size_t)req * max_pages;
  const size_t page_elems = (size_t)page_size * hd;
  const int page_shift = __popc(page_size) == 1 ? __ffs(page_size) - 1 : -1;
  // Softmax units: the raw logit q.k without a cap (scale folded into the
  // exponent), the capped scaled logit with one.
  const float mult = (kCap ? 1.f : scale) * 1.4426950408889634f;
  const float cap_scale = kCap ? scale / soft_cap : 0.f;

  extern __shared__ uint4 smem_tc[];
  T* q_s = reinterpret_cast<T*>(smem_tc);  // [rows, P]
  T* kv_s = q_s + C::kRows * P;             // [stages][K, V][BN, P]
  // fp8: [stages][K, V][BN, HD] bytes, converted into kv_s's stage.
  uint8_t* stg = reinterpret_cast<uint8_t*>(smem_tc) + C::kRing;

  // Q, row r = token r / group, query head h * group + r % group; rows
  // past the item, and columns past hd, are zero.
#pragma unroll 4
  for (int k = 0; k < C::kRows * CPR / C::kThreads; ++k) {
    const int i = tid + k * C::kThreads;
    const int r = i / CPR, c = i - r * CPR;
    const bool ok = r < rows && c * 8 < hd;
    const T* src = q;
    if (ok) {
      const int t = r / group, g = r - t * group;
      src = q + ((size_t)(qstart + t) * nq + h * group + g) * hd + c * 8;
    }
    cp_async16(q_s + r * P + c * 8, src, ok);
  }
  // K/V tile t (keys t * BN ...) into ring stage `stage` (fp8: its
  // staged bytes), each thread finding its key rows' pages; keys at or
  // past kv_limit, and copies past the row's hd columns, are zero. Copy c
  // of a row is its bytes [16 c, 16 c + 16).
  auto load_tile = [&](int t, int stage) {
    T* ks = kv_s + (size_t)stage * 2 * BN * P;
    uint8_t* kb = stg + (size_t)stage * 2 * BN * HD;
#pragma unroll
    for (int k = 0; k < BN * KCPR / C::kThreads; ++k) {
      const int i = tid + k * C::kThreads;
      const int j = i / KCPR, c = i - j * KCPR;
      const int pos = t * BN + j;
      const bool ok = pos < kv_limit && c * kCopyElems < hd;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(cache);
      if (ok) {
        const int pg = page_shift >= 0 ? pos >> page_shift : pos / page_size;
        src += (((size_t)bt[pg] * 2 * kvh + h) * page_elems +
                (size_t)((pos - pg * page_size) * hd)) * sizeof(KV) + c * 16;
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
  const bool ali = kAlibi || (kSpans && alibi != nullptr);  // block-uniform
  [[maybe_unused]] float sl[MT][2], qpf[MT][2];
  if (ali) {
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
  // Spans: each of this lane's rows' keys [s_lo, s_hi), and the last key
  // any row of the warp sees (w_end: past w_hi where a span reaches on).
  [[maybe_unused]] int s_lo[MT][2], s_hi[MT][2];
  int w_end = w_hi;
  if constexpr (kSpans) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        row_span(sp, num_spans, qp[mt][hf], s_lo[mt][hf], s_hi[mt][hf]);
        w_end = max(w_end, s_hi[mt][hf] - 1);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      w_end = max(w_end, __shfl_xor_sync(0xffffffffu, w_end, o));
  }
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
  const T* q_w = q_s + (w_row + (lane & 15)) * P + (lane >> 4) * 8;
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
    if constexpr (kFp8)  // its bytes into the stage's tile of T
      convert_rows<KV, HD, T>(stg + (size_t)(it % C::kStages) * 2 * BN * HD,
                              kv_s + (size_t)(it % C::kStages) * 2 * BN * P,
                              2 * BN, P, tid, C::kThreads);
    {
      const int nx = it + C::kStages - 1;
      if (nx < n_tiles) load_tile(t_lo + nx, nx % C::kStages);
      cp_async_commit();
    }
    if constexpr (kFp8) __syncthreads();  // the converted tile is whole
    const int kv0 = (t_lo + it) * BN;
    if (!warp_live || kv0 > w_end || kv0 + BN <= w_first) continue;
    const T* ks = kv_s + (size_t)(it % C::kStages) * 2 * BN * P;
    const T* vs = ks + BN * P;

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
          mma16816<T>(s[mt][2 * np], a[mt], b);
          mma16816<T>(s[mt][2 * np + 1], a[mt], b + 2);
        }
      }
    }

    // ALiBi, the soft cap (on the scaled logit), then the mask where some
    // key is hidden from some row of the warp: switches and uniform
    // branches around whole loops, so that no lane issues what its tile
    // does not need. Spans only add visible keys, so a full tile stays
    // full; past the diagonal a key is visible where it lies in its row's
    // span and below kv_limit (the tile's keys past it are zeros).
    if (ali) {
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
            bool vis = kv <= qpos;
            if constexpr (kSpans)
              vis = (vis || (kv >= s_lo[mt][e >> 1] &&
                             kv < s_hi[mt][e >> 1])) &&
                    kv < kv_limit;
            if (!vis || !local_ok(kv, qpos, sliding_window, chunk_attn))
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

    // O += P V: P's accumulators, rounded to T (the TPU kernel rounds P to
    // V's dtype, :225-227), are the A fragments of 16-key chunks.
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack<T>(s[mt][2 * kc][0], s[mt][2 * kc][1]);
        a[mt][1] = pack<T>(s[mt][2 * kc][2], s[mt][2 * kc][3]);
        a[mt][2] = pack<T>(s[mt][2 * kc + 1][0], s[mt][2 * kc + 1][1]);
        a[mt][3] = pack<T>(s[mt][2 * kc + 1][2], s[mt][2 * kc + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + kc * 16 * P + dp * 16 + v_off);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816<T>(o[mt][2 * dp], a[mt], b);
          mma16816<T>(o[mt][2 * dp + 1], a[mt], b + 2);
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
      T* dst =
          out + ((size_t)(qstart + t) * nq + h * group + g) * hd + 2 * tq;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        if (d * 8 >= hd) break;  // the hd columns stored
        *reinterpret_cast<uint32_t*>(dst + d * 8) =
            pack<T>(o[mt][d][2 * hf] * inv, o[mt][d][2 * hf + 1] * inv);
      }
    }
}

template <typename T, int HD, bool kCap, bool kAlibi, bool kSpans,
          typename KV>
int launch_tc(const void* q, const void* cache, void* out,
              const int* item_req, const int* item_qstart,
              const int* item_qlen, const int* item_pos, const int* seq_lens,
              const int* block_tables, int num_items, int max_pages, int nq,
              int kvh, int page_size, int hd, float scale,
              int sliding_window, int chunk_attn, float soft_cap,
              const float* alibi, const int* spans, int num_spans,
              cudaStream_t stream) {
  using C = TcCfg<HD, KV>;
  const cudaError_t err =
      mma::allow_smem<rpa_tc_kernel<T, HD, kCap, kAlibi, kSpans, KV>>(
          C::kSmem);
  if (err != cudaSuccess) return (int)err;
  rpa_tc_kernel<T, HD, kCap, kAlibi, kSpans, KV>
      <<<dim3(num_items, kvh), C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(cache),
      static_cast<T*>(out), item_req, item_qstart, item_qlen,
      item_pos, seq_lens, block_tables, max_pages, nq, kvh, page_size, hd,
      scale, sliding_window, chunk_attn, soft_cap, alibi, spans, num_spans);
  return (int)cudaGetLastError();
}

// The tensor-core kernel's launch for the instances of element type T
// (q's dtype code `dtype` must name it: the entry runs no other type's
// instance) with (kSpans) or without image spans: the switches of the
// tiles' width (the narrowest of 64, 128 and 256 that holds hd, a multiple
// of 16), the cache's dtype, the soft cap and ALiBi (the span instances
// take the slopes as a uniform branch). Returns a cudaError_t.
template <bool kSpans, typename T>
int rpa_tc_dispatch(int dtype, int kv_dtype, const void* q,
                    const void* cache_layer, void* out,
                    const int* item_req, const int* item_qstart,
                    const int* item_qlen, const int* item_pos,
                    const int* seq_lens, const int* block_tables,
                    int num_items, int max_pages, int nq, int kvh,
                    int page_size, int hd, int block_q, float scale,
                    int sliding_window, int chunk_attn, float soft_cap,
                    const float* alibi, const int* spans, int num_spans,
                    cudaStream_t s) {
  const bool cap = soft_cap > 0.f, ali = alibi != nullptr;
  constexpr int kCode =
      std::is_same<T, __half>::value ? kFloat16 : kBFloat16;
  if (dtype != kCode || kvh <= 0 || nq % kvh || block_q <= 0 ||
      hd < 16 || hd % 16 || (spans != nullptr) != kSpans ||
      (kSpans && num_spans <= 0))
    return (int)cudaErrorInvalidValue;
  const int rows = block_q * (nq / kvh);
#define RPA_TC(HD, KV)                                                      \
  if (hd <= HD) {                                                           \
    if (rows > TcCfg<HD, KV>::kRows) return (int)cudaErrorInvalidValue;     \
    return (cap ? (ali ? launch_tc<T, HD, true, !kSpans, kSpans, KV>        \
                       : launch_tc<T, HD, true, false, kSpans, KV>)         \
                : (ali ? launch_tc<T, HD, false, !kSpans, kSpans, KV>       \
                       : launch_tc<T, HD, false, false, kSpans, KV>))(      \
        q, cache_layer, out, item_req, item_qstart, item_qlen, item_pos,    \
        seq_lens, block_tables, num_items, max_pages, nq, kvh, page_size,   \
        hd, scale, sliding_window, chunk_attn, soft_cap, alibi, spans,      \
        num_spans, s);                                                      \
  }
#define RPA_TC_KV(KV) \
  RPA_TC(64, KV)      \
  RPA_TC(128, KV)     \
  RPA_TC(256, KV)     \
  return (int)cudaErrorInvalidValue;
  if (kv_dtype == kKvAuto) {
    RPA_TC_KV(T)
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

}  // namespace
