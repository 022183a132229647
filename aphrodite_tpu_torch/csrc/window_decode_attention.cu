// Window decode attention (CUDA, sm_90a).
//
// Replaces the TPU kernel `window_decode_attention` / `_wd_kernel` of
// aphrodite_tpu/ops/window_decode_attention.py. During a decode window the
// paged KV cache is frozen; each request r has one query token at position
// paged_lens[r] + step, which attends to the pages' positions
// < paged_lens[r] and to the tail slots j <= step that this window has
// written so far (tail [R, kvh, Kw, hd] of one layer). Sliding window,
// chunked local attention and logit soft cap (on the scaled logit, before
// the mask) as in the TPU kernel. Fully masked rows give 0, never NaN.
//
// Cascade init state (the TPU kernel's cascade_init / shared_len): when
// every request shares its first S page positions, the shared-prefix pass
// (csrc/shared_prefix_attention.cu) has already attended them; the splits
// read only page positions >= S, and the pass's unnormalized state
// (acc0, m0, l0) enters the merge once, as one more state. The merge's
// kCascade template switch keeps the option out of the plain instance (as
// a runtime option it once cost ~27 % of every launch through a spill).
//
// Bound. One launch at the 8B path's decode step (R 32, 32 / 8 heads of
// 128, ~560 visible keys) reads ~73 MB of K/V in bf16: bound by bytes,
// >= 22 us at 3.35 TB/s; at phase 14 (R 128 from the cascade's state,
// ~150 keys a request) ~80 MB, >= 25 us. The products are ~1 FLOP a byte.
//
// Design: split-KV. The visible keys of a request (its page positions
// from the first visible one, then its tail slots) are cut into tiles of
// 64 keys; the grid is (request, KV head, split), and split s takes tiles
// [s * tps, (s + 1) * tps), the last split all the rest. The host plan
// (ops/window_decode_attention.py: window_split_plan) picks the splits
// from a bound on the longest visible range so that the card gets about
// four blocks an SM, at least two tiles a split (so that a block's next
// load overlaps its products); a bound too low costs speed, not keys. A
// split past a request's tiles is empty and writes the state m = -inf. Each
// split writes its unnormalized (acc, m, l), m in the scaled logit's
// units, to a scratch buffer, and wd_merge_kernel, launched right after it
// on the same stream, merges the init state and the splits in a fixed
// order (init, split 0, 1, ...): no atomics, so a run is deterministic.
//
// wd_split_tc_kernel (bf16 at head_dim 64, 128 or 256, groups <= 16): 4
// warps stage each tile of K and V in bf16 by 16-byte cp.async, double
// buffered, every thread finding its key row's page through the block
// table; warp w takes keys [16w, 16w + 16) of every tile with mma.sync
// m16n8k16, the group's rows padded to 16 as the A operand (kept in
// registers at head_dim <= 128, re-read from shared memory at 256). The
// padding is wasted work the bytes bound does not see. At the end the
// block merges its warps' states in shared memory (the ring's space).
//
// wd_split_kernel (fp32; bf16 at other head dims or larger groups): the
// same tiles and states on the CUDA cores in full fp32 (no TF32), with the
// first version's per-warp staging: sub-tiles of up to 32 keys within a
// page, lane j owning key j, warps taking sub-tiles in turn.
//
// What holds it back (PERF.md): its device time is 1.4-2.6x the bytes
// bound at the main paths, and a call's host time (the Python wrapper,
// ~65 us) exceeds it. At head_dim 256 the 143 KB ring leaves one block an
// SM. Left for later: TMA loads with a producer warp, a smaller ring at
// head_dim 256, and folding the merge into the last split of each
// (request, head) when there is one split.
#include "attn_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kKeys = 64;     // keys a tile: the host plan's unit
constexpr int kMaxWarps = 4;  // warps a block of either split kernel

// A request's tiles: page tiles from the one holding its first visible
// position lo (>= shared_len, the cascade's prefix), then tail tiles.
struct Tiles {
  int lo, t0, n_paged, n;
};

__device__ __forceinline__ Tiles request_tiles(int plen, int step,
                                               int sliding_window,
                                               int chunk_attn,
                                               int shared_len) {
  Tiles tl;
  tl.lo = attn::first_visible(plen + step, sliding_window, chunk_attn);
  tl.lo = min(max(tl.lo, shared_len), plen);
  tl.t0 = tl.lo / kKeys;
  tl.n_paged = (plen + kKeys - 1) / kKeys - tl.t0;
  tl.n = tl.n_paged + (step + kKeys) / kKeys;  // + ceil((step + 1) / 64)
  return tl;
}

// Tiles of the split that starts at tile ta: tiles_per_split, fewer at the
// request's end, none past it; the last split takes all the rest, so that a
// plan made from too low a bound on the context costs speed, never keys.
__device__ __forceinline__ int my_tiles(int n, int ta, int tiles_per_split,
                                        int split, int splits) {
  const int end = split == splits - 1 ? n : min(ta + tiles_per_split, n);
  return max(end - ta, 0);
}

// Writes the block's state of its group rows: acc [group, hd] at
// part_acc[row, split], m and l at part_m/part_l[row, split], row = r * nq
// + h * group + g.
__device__ __forceinline__ void write_state(float* part_acc, float* part_m,
                                            float* part_l, size_t row,
                                            int split, int splits, int hd,
                                            int d, float acc, float m,
                                            float l) {
  part_acc[(row * splits + split) * hd + d] = acc;
  if (d == 0) {
    part_m[row * splits + split] = m;
    part_l[row * splits + split] = l;
  }
}

// Merge of W per-warp states in shared memory (acc [W][16][hd], m and l
// [W][16], pitch 16 rows) into the block's state, written to the scratch.
__device__ __forceinline__ void merge_warps(const float* acc_w,
                                            const float* m_w,
                                            const float* l_w, int n_warps,
                                            int group, int hd, size_t row0,
                                            int split, int splits,
                                            float* part_acc, float* part_m,
                                            float* part_l) {
  for (int i = threadIdx.x; i < group * hd; i += blockDim.x) {
    const int g = i / hd, d = i - g * hd;
    float m = -INFINITY;
    for (int w = 0; w < n_warps; ++w) m = fmaxf(m, m_w[w * 16 + g]);
    float acc = 0.f, l = 0.f;
    if (m != -INFINITY) {
      for (int w = 0; w < n_warps; ++w) {
        const float mw = m_w[w * 16 + g];
        if (mw == -INFINITY) continue;
        const float c = expf(mw - m);
        acc += acc_w[((size_t)w * 16 + g) * hd + d] * c;
        l += l_w[w * 16 + g] * c;
      }
    }
    write_state(part_acc, part_m, part_l, row0 + g, split, splits, hd, d,
                acc, m, l);
  }
}

// ------------------------------------------------ tensor-core split (bf16)
template <int HD>
struct WdCfg {
  static constexpr int kPitch = HD + 8;  // bf16 a staged row
  static constexpr bool kQInRegs = HD <= 128;
  // Q [16, P], then a ring of 2 stages of K and V [64, P]; after the loop
  // the ring holds the warps' states (acc [4][16][HD], m and l [4][16]).
  static constexpr int kSmem = (16 + 2 * 2 * kKeys) * kPitch * 2;
  static_assert(4 * 16 * HD * 4 + 2 * 4 * 16 * 4 <= 2 * 2 * kKeys * kPitch * 2,
                "the warps' states fit the ring");
};

template <int HD>
__global__ void __launch_bounds__(kMaxWarps * 32)
wd_split_tc_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ cache,
                   const __nv_bfloat16* __restrict__ tail_k,
                   const __nv_bfloat16* __restrict__ tail_v,
                   float* __restrict__ part_acc, float* __restrict__ part_m,
                   float* __restrict__ part_l,
                   const int* __restrict__ paged_lens,
                   const int* __restrict__ block_tables, int max_pages,
                   int nq, int kvh, int page_size, int kw, int step,
                   float scale, int sliding_window, int chunk_attn,
                   float soft_cap, int shared_len, int tiles_per_split) {
  using namespace attn;
  using namespace mma;
  using C = WdCfg<HD>;
  constexpr int P = C::kPitch, CPR = HD / 8, kThreads = kMaxWarps * 32;
  const int r = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z, group = nq / kvh;
  const int plen = paged_lens[r], q_pos = plen + step;
  const Tiles tl =
      request_tiles(plen, step, sliding_window, chunk_attn, shared_len);
  const int ta = split * tiles_per_split;
  const int n_my = my_tiles(tl.n, ta, tiles_per_split, split, splits);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int* bt = block_tables + (size_t)r * max_pages;
  const size_t page_elems = (size_t)page_size * HD;
  const int page_shift = __popc(page_size) == 1 ? __ffs(page_size) - 1 : -1;
  const size_t tail_base = ((size_t)r * kvh + h) * kw * HD;
  const size_t row0 = (size_t)r * nq + h * group;
  // Softmax units: the raw logit q.k without a cap (scale folded into the
  // exponent), the capped scaled logit with one.
  const float mult = (soft_cap > 0.f ? 1.f : scale) * 1.4426950408889634f;
  const float cap_scale = soft_cap > 0.f ? scale / soft_cap : 0.f;

  extern __shared__ uint4 smem_wd[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_wd);  // [16, P]
  __nv_bfloat16* kv_s = q_s + 16 * P;  // [2 stages][K, V][64, P]

  for (int i = tid; i < 16 * CPR; i += kThreads) {
    const int g = i / CPR, c = i - g * CPR;
    const bool ok = g < group;
    cp_async16(q_s + g * P + c * 8, ok ? q + (row0 + g) * HD + c * 8 : q, ok);
  }
  // Tile ta + it into stage `stage`; masked keys are not read (zeros).
  auto load_tile = [&](int it, int stage) {
    __nv_bfloat16* ks = kv_s + (size_t)stage * 2 * kKeys * P;
    __nv_bfloat16* vs = ks + kKeys * P;
    const int t = ta + it;
    const bool paged = t < tl.n_paged;
    const int kv0 = paged ? (tl.t0 + t) * kKeys : (t - tl.n_paged) * kKeys;
#pragma unroll
    for (int u = 0; u < kKeys * CPR / kThreads; ++u) {
      const int i = tid + u * kThreads;
      const int j = i / CPR, c = i - j * CPR;
      const int k = kv0 + j;  // page position or tail slot
      const __nv_bfloat16 *ksrc = cache, *vsrc = cache;
      bool ok;
      if (paged) {
        ok = k >= tl.lo && k < plen;
        if (ok) {
          const int pg = page_shift >= 0 ? k >> page_shift : k / page_size;
          ksrc = cache + ((size_t)bt[pg] * 2 * kvh + h) * page_elems +
                 (size_t)(k - pg * page_size) * HD + c * 8;
          vsrc = ksrc + kvh * page_elems;
        }
      } else {
        ok = k <= step;
        if (ok) {
          ksrc = tail_k + tail_base + (size_t)k * HD + c * 8;
          vsrc = tail_v + tail_base + (size_t)k * HD + c * 8;
        }
      }
      cp_async16(ks + j * P + c * 8, ksrc, ok);
      cp_async16(vs + j * P + c * 8, vsrc, ok);
    }
  };

  uint32_t qf[C::kQInRegs ? HD / 16 : 1][4];
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const __nv_bfloat16* q_w = q_s + (lane & 15) * P + (lane >> 4) * 8;

  if (n_my > 0) load_tile(0, 0);
  cp_async_commit();  // with Q
  for (int it = 0; it < n_my; ++it) {
    cp_async_wait<0>();  // tile it has landed
    __syncthreads();     // and tile it - 1 is consumed
    if (it + 1 < n_my) load_tile(it + 1, (it + 1) & 1);
    cp_async_commit();
    if constexpr (C::kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < HD / 16; ++kc) ldmatrix_x4(qf[kc], q_w + kc * 16);
      }
    }
    // This warp's 16 keys of the tile.
    const __nv_bfloat16* ks =
        kv_s + (size_t)(it & 1) * 2 * kKeys * P + warp * 16 * P;
    const __nv_bfloat16* vs = ks + kKeys * P;
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t a_s[4];
      const uint32_t* a = a_s;
      if constexpr (C::kQInRegs) a = qf[kc];
      else ldmatrix_x4(a_s, q_w + kc * 16);
      uint32_t b[4];
      ldmatrix_x4(b, ks + ((lane & 7) + ((lane >> 4) << 3)) * P + kc * 16 +
                         ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], a, b);
      mma_bf16(s[1], a, b + 2);
    }
    // Soft cap (uniform branch), then the mask: one query position for
    // every row, so it depends on the key only. m is kept in logit units;
    // the exponents are base 2 with the scale folded in (mult).
    if (soft_cap > 0.f) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = soft_cap * tanhf(s[nt][e] * cap_scale);
    }
    const int t = ta + it;
    const bool paged = t < tl.n_paged;
    const int kv0 = (paged ? (tl.t0 + t) * kKeys : (t - tl.n_paged) * kKeys) +
                    warp * 16;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = kv0 + nt * 8 + 2 * tq + e;
        const bool ok =
            paged ? k >= tl.lo && k < plen &&
                        local_ok(k, q_pos, sliding_window, chunk_attn)
                  : k <= step &&
                        local_ok(plen + k, q_pos, sliding_window, chunk_attn);
        if (!ok) s[nt][e] = s[nt][e + 2] = -INFINITY;
      }
    float mx_a = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    float mx_b = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a * mult;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b * mult;
    const float al_a = fast_exp2(m_a * mult - base_a);
    const float al_b = fast_exp2(m_b * mult - base_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      s[nt][0] = fast_exp2(fmaf(s[nt][0], mult, -base_a));
      s[nt][1] = fast_exp2(fmaf(s[nt][1], mult, -base_a));
      s[nt][2] = fast_exp2(fmaf(s[nt][2], mult, -base_b));
      s[nt][3] = fast_exp2(fmaf(s[nt][3], mult, -base_b));
    }
    l_a = l_a * al_a + s[0][0] + s[0][1] + s[1][0] + s[1][1];
    l_b = l_b * al_b + s[0][2] + s[0][3] + s[1][2] + s[1][3];
    uint32_t a[4];
    a[0] = pack_bf16(s[0][0], s[0][1]);
    a[1] = pack_bf16(s[0][2], s[0][3]);
    a[2] = pack_bf16(s[1][0], s[1][1]);
    a[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      o[2 * dp][0] *= al_a;
      o[2 * dp][1] *= al_a;
      o[2 * dp][2] *= al_b;
      o[2 * dp][3] *= al_b;
      o[2 * dp + 1][0] *= al_a;
      o[2 * dp + 1][1] *= al_a;
      o[2 * dp + 1][2] *= al_b;
      o[2 * dp + 1][3] *= al_b;
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + (lane & 15) * P + dp * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dp], a, b);
      mma_bf16(o[2 * dp + 1], a, b + 2);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' states

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o_);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o_);
  }
  float* acc_w = reinterpret_cast<float*>(kv_s);  // [4][16][HD]
  float* m_w = acc_w + kMaxWarps * 16 * HD;       // [4][16]
  float* l_w = m_w + kMaxWarps * 16;              // [4][16]
  float* aw = acc_w + (size_t)warp * 16 * HD;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int col = d * 8 + 2 * tq;
    aw[gq * HD + col] = o[d][0];
    aw[gq * HD + col + 1] = o[d][1];
    aw[(gq + 8) * HD + col] = o[d][2];
    aw[(gq + 8) * HD + col + 1] = o[d][3];
  }
  if (tq == 0) {  // m in the scaled logit's units, as every merged state
    const float to_scaled = mult * 0.6931471805599453f;
    m_w[warp * 16 + gq] = m_a * to_scaled;
    l_w[warp * 16 + gq] = l_a;
    m_w[warp * 16 + gq + 8] = m_b * to_scaled;
    l_w[warp * 16 + gq + 8] = l_b;
  }
  __syncthreads();
  merge_warps(acc_w, m_w, l_w, kMaxWarps, group, HD, row0, split, splits,
              part_acc, part_m, part_l);
}

// ------------------------------------------------------ CUDA-core split
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
wd_split_kernel(const T* __restrict__ q, const T* __restrict__ cache,
                const T* __restrict__ tail_k, const T* __restrict__ tail_v,
                float* __restrict__ part_acc, float* __restrict__ part_m,
                float* __restrict__ part_l,
                const int* __restrict__ paged_lens,
                const int* __restrict__ block_tables, int max_pages, int nq,
                int kvh, int page_size, int hd, int kw, int step,
                float scale, int sliding_window, int chunk_attn,
                float soft_cap, int shared_len, int tiles_per_split) {
  using namespace attn;
  const int r = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z, group = nq / kvh;
  const int plen = paged_lens[r], q_pos = plen + step;
  const Tiles tl =
      request_tiles(plen, step, sliding_window, chunk_attn, shared_len);
  const int ta = split * tiles_per_split;
  const int n_my = my_tiles(tl.n, ta, tiles_per_split, split, splits);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  // Sub-tiles of `sub` keys: a power of two dividing both the page and 32,
  // so that one never straddles a page or a 64-key tile.
  int sub = kTile;
  while (page_size % sub) sub >>= 1;
  const int per_tile = kKeys / sub;
  const size_t row0 = (size_t)r * nq + h * group;

  extern __shared__ float smem[];
  float* q_s = smem;                                    // [group, hd]
  const size_t per_warp = (size_t)kTile * (hd + 1) + kTile * hd + kTile +
                          (size_t)group * hd + 2 * group;
  float* w_s = q_s + (size_t)group * hd + warp * per_warp;
  float* k_s = w_s;                                     // [kTile, hd + 1]
  float* v_s = k_s + kTile * (hd + 1);                  // [kTile, hd]
  float* p_w = v_s + kTile * hd;                        // [kTile]
  float* acc_w = p_w + kTile;                           // [group, hd]
  float* m_w = acc_w + (size_t)group * hd;              // [group]
  float* l_w = m_w + group;                             // [group]

  for (int i = threadIdx.x; i < group * hd; i += blockDim.x)
    q_s[i] = to_float(q[row0 * hd + i]);
  for (int i = lane; i < group * hd; i += 32) acc_w[i] = 0.f;
  for (int g = lane; g < group; g += 32) {
    m_w[g] = -INFINITY;
    l_w[g] = 0.f;
  }
  __syncthreads();

  const size_t page_elems = (size_t)page_size * hd;
  const size_t tail_base = ((size_t)r * kvh + h) * kw * hd;
  for (int u = warp; u < n_my * per_tile; u += n_warps) {
    const int t = ta + u / per_tile, k0 = (u % per_tile) * sub;
    const T *kb, *vb;
    int n, kv0;
    bool paged = t < tl.n_paged;
    if (paged) {
      kv0 = (tl.t0 + t) * kKeys + k0;
      n = min(sub, plen - kv0);
      if (n <= 0 || kv0 + sub <= tl.lo) continue;  // nothing visible
      const int page_id = block_tables[(size_t)r * max_pages + kv0 / page_size];
      const size_t base = ((size_t)page_id * 2 * kvh + h) * page_elems +
                          (size_t)(kv0 % page_size) * hd;
      kb = cache + base;
      vb = cache + base + kvh * page_elems;
    } else {
      const int j0 = (t - tl.n_paged) * kKeys + k0;
      n = min(sub, step + 1 - j0);
      if (n <= 0) continue;
      kv0 = plen + j0;
      kb = tail_k + tail_base + (size_t)j0 * hd;
      vb = tail_v + tail_base + (size_t)j0 * hd;
    }
    __syncwarp();  // this warp's previous sub-tile fully consumed
    load_tile(kb, vb, n, hd, k_s, v_s, lane, 32);
    __syncwarp();
    const int kv_pos = kv0 + lane;
    const bool valid = lane < n && (!paged || kv_pos >= tl.lo) &&
                       local_ok(kv_pos, q_pos, sliding_window, chunk_attn);
    for (int g = 0; g < group; ++g)
      tile_update(q_s + (size_t)g * hd, k_s, v_s, n, hd, valid, scale,
                  soft_cap, acc_w + (size_t)g * hd, m_w + g, l_w + g, p_w,
                  lane);
  }
  __syncthreads();

  // Merge the warps' states into the block's.
  for (int i = threadIdx.x; i < group * hd; i += blockDim.x) {
    const int g = i / hd, d = i - g * hd;
    float m = -INFINITY;
    for (int w = 0; w < n_warps; ++w)
      m = fmaxf(m, q_s[group * hd + w * per_warp + kTile * (2 * hd + 2) +
                       (size_t)group * hd + g]);
    float acc = 0.f, l = 0.f;
    if (m != -INFINITY) {
      for (int w = 0; w < n_warps; ++w) {
        const float* ws = q_s + (size_t)group * hd + w * per_warp;
        const float* aw = ws + kTile * (2 * hd + 2);
        const float mw = aw[(size_t)group * hd + g];
        if (mw == -INFINITY) continue;
        const float c = expf(mw - m);
        acc += aw[i] * c;
        l += aw[(size_t)group * hd + group + g] * c;
      }
    }
    write_state(part_acc, part_m, part_l, row0 + g, split, splits, hd, d,
                acc, m, l);
  }
}

// ---------------------------------------------------------------- merge
// One block a query row (r * nq + query head): the init state, then the
// splits in order, each scaled to the common max; out = acc / max(l, 1e-20).
template <typename T, bool kCascade>
__global__ void __launch_bounds__(128)
wd_merge_kernel(const float* __restrict__ part_acc,
                const float* __restrict__ part_m,
                const float* __restrict__ part_l, T* __restrict__ out,
                const float* __restrict__ acc0, const float* __restrict__ m0,
                const float* __restrict__ l0, int hd, int splits) {
  const size_t row = blockIdx.x;
  const float* pm = part_m + row * splits;
  const float* pl = part_l + row * splits;
  const float m_init = kCascade ? m0[row] : -INFINITY;
  float m = m_init;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, pm[s]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float acc = 0.f, l = 0.f;
    if (m != -INFINITY) {
      if (kCascade && m_init != -INFINITY) {
        const float c = expf(m_init - m);
        acc = acc0[row * hd + d] * c;
        l = l0[row] * c;
      }
      for (int s = 0; s < splits; ++s) {
        if (pm[s] == -INFINITY) continue;
        const float c = expf(pm[s] - m);
        acc += part_acc[(row * splits + s) * hd + d] * c;
        l += pl[s] * c;
      }
    }
    out[row * hd + d] = attn::from_float<T>(acc / fmaxf(l, 1e-20f));
  }
}

struct Args {
  const void *q, *cache, *tail_k, *tail_v;
  void* out;
  float *part_acc, *part_m, *part_l;
  const int *paged_lens, *block_tables;
  int num_reqs, max_pages, nq, kvh, page_size, hd, kw, step;
  float scale;
  int sliding_window, chunk_attn;
  float soft_cap;
  const float *acc0, *m0, *l0;
  int shared_len, splits, tiles_per_split, warps, smem_bytes;
  cudaStream_t stream;
};

template <int HD>
int split_tc(const Args& a) {
  const cudaError_t err =
      mma::allow_smem<wd_split_tc_kernel<HD>>(WdCfg<HD>::kSmem);
  if (err != cudaSuccess) return (int)err;
  wd_split_tc_kernel<HD>
      <<<dim3(a.num_reqs, a.kvh, a.splits), kMaxWarps * 32, WdCfg<HD>::kSmem,
         a.stream>>>(
          static_cast<const __nv_bfloat16*>(a.q),
          static_cast<const __nv_bfloat16*>(a.cache),
          static_cast<const __nv_bfloat16*>(a.tail_k),
          static_cast<const __nv_bfloat16*>(a.tail_v), a.part_acc, a.part_m,
          a.part_l, a.paged_lens, a.block_tables, a.max_pages, a.nq, a.kvh,
          a.page_size, a.kw, a.step, a.scale, a.sliding_window, a.chunk_attn,
          a.soft_cap, a.shared_len, a.tiles_per_split);
  return (int)cudaGetLastError();
}

template <typename T>
int split_cuda_cores(const Args& a) {
  const cudaError_t err = mma::allow_smem<wd_split_kernel<T>>(a.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  wd_split_kernel<T><<<dim3(a.num_reqs, a.kvh, a.splits), a.warps * 32,
                       a.smem_bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.cache),
      static_cast<const T*>(a.tail_k), static_cast<const T*>(a.tail_v),
      a.part_acc, a.part_m, a.part_l, a.paged_lens, a.block_tables,
      a.max_pages, a.nq, a.kvh, a.page_size, a.hd, a.kw, a.step, a.scale,
      a.sliding_window, a.chunk_attn, a.soft_cap, a.shared_len,
      a.tiles_per_split);
  return (int)cudaGetLastError();
}

template <typename T>
int merge(const Args& a) {
  const dim3 grid(a.num_reqs * a.nq);
  if (a.acc0 != nullptr)
    wd_merge_kernel<T, true><<<grid, 128, 0, a.stream>>>(
        a.part_acc, a.part_m, a.part_l, static_cast<T*>(a.out), a.acc0,
        a.m0, a.l0, a.hd, a.splits);
  else
    wd_merge_kernel<T, false><<<grid, 128, 0, a.stream>>>(
        a.part_acc, a.part_m, a.part_l, static_cast<T*>(a.out), nullptr,
        nullptr, nullptr, a.hd, a.splits);
  return (int)cudaGetLastError();
}

}  // namespace

// One call launches the split kernel, then the merge, on `stream`.
// tensor_cores: the bf16 instance (head_dim 64, 128 or 256, nq / kvh <=
// 16); else the CUDA-core one with `warps` warps and `smem_bytes` of shared
// memory (ops/window_decode_attention.py: window_warps). part_acc
// [R, nq, splits, hd], part_m and part_l [R, nq, splits] fp32 scratch.
// acc0 [R, nq, hd], m0 and l0 [R, nq] (fp32): the cascade's init state
// covering page positions < shared_len, or all three null (shared_len 0).
extern "C" int wd_launch(int dtype, int tensor_cores, const void* q,
                         const void* cache_layer, const void* tail_k_layer,
                         const void* tail_v_layer, void* out, float* part_acc,
                         float* part_m, float* part_l, const int* paged_lens,
                         const int* block_tables, int num_reqs, int max_pages,
                         int nq, int kvh, int page_size, int hd, int kw,
                         int step, float scale, int sliding_window,
                         int chunk_attn, float soft_cap, const float* acc0,
                         const float* m0, const float* l0, int shared_len,
                         int splits, int tiles_per_split, int warps,
                         int smem_bytes, void* stream) {
  if ((acc0 == nullptr) != (m0 == nullptr) ||
      (acc0 == nullptr) != (l0 == nullptr) || shared_len < 0 ||
      (acc0 == nullptr && shared_len != 0) || kvh <= 0 || nq % kvh ||
      splits < 1 || tiles_per_split < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, cache_layer, tail_k_layer, tail_v_layer, out, part_acc,
               part_m, part_l, paged_lens, block_tables, num_reqs, max_pages,
               nq, kvh, page_size, hd, kw, step, scale, sliding_window,
               chunk_attn, soft_cap, acc0, m0, l0, shared_len, splits,
               tiles_per_split, warps, smem_bytes,
               static_cast<cudaStream_t>(stream)};
  int err = (int)cudaErrorInvalidValue;
  if (tensor_cores) {
    if (dtype != kBFloat16 || nq / kvh > 16) return err;
    if (hd == 64) err = split_tc<64>(a);
    else if (hd == 128) err = split_tc<128>(a);
    else if (hd == 256) err = split_tc<256>(a);
    if (err != 0) return err;
    return merge<__nv_bfloat16>(a);
  }
  if (warps < 1 || warps > kMaxWarps) return err;
  if (dtype == kFloat32) {
    err = split_cuda_cores<float>(a);
    return err != 0 ? err : merge<float>(a);
  }
  if (dtype == kBFloat16) {
    err = split_cuda_cores<__nv_bfloat16>(a);
    return err != 0 ? err : merge<__nv_bfloat16>(a);
  }
  return err;
}
