// Split-KV decode attention on the tensor cores, shared by the window kernel
// (csrc/window_decode_attention.cu) and the decode kernel
// (csrc/decode_paged_attention.cu): one query token a request, its visible
// keys cut into tiles and the tiles into splits, one block a (request, KV
// head, split; the decode kernel also cuts a group past 16 query heads into
// row slices of 16, a block each). Each block writes its unnormalized state
// (acc [group, hd], m, l; m in the scaled logit's units) to a scratch
// buffer, and a merge launched right after it on the same stream adds the
// splits in a fixed order (an init state first where there is one): no
// atomics, so a run is deterministic.
//
// The tile loop (tc_split): 4 warps stage each tile of K and V in q's dtype
// T (bf16 or fp16, a template parameter) by 16-byte cp.async, double
// buffered, every thread finding its key row's source through the caller's
// key policy (pages through the block table, or the window's tail). A tile
// of an fp8 cache (or of the window's e4m3 tail) is staged as its bytes in a
// second double-buffered ring and converted into the tile of T once it lands
// (attn::convert_rows): the products then run as on a cache of q's dtype, as
// the TPU kernels upcast fp8 K/V to q's dtype before both products. Under
// fp16 queries the window's bf16 tails (beside an e5m2 cache) are staged as
// they are and converted to fp16 in place (attn::bf16_rows_to_f16: exact
// inside fp16's range), so that both products of every tile take fp16
// operands; the Pallas kernel multiplies fp16 q by the bf16 tail in fp32 and
// rounds the tail's P to bf16 (window_decode_attention.py:182-187, 127-129),
// which this kernel rounds to fp16. The block's query rows (at most 16) are
// padded to 16 as the A operand of mma.sync m16n8k16 (in registers in tiles
// up to 128 wide, re-read from shared memory at 256). The tiles are HD wide
// (64, 128 or 256) and the model's head_dim hd (a multiple of 16, at most
// HD) is a run-time argument: global rows stride by hd, the copies past it
// are zero-filled and the state's padded columns not written (the window
// kernel passes hd = HD, so its instances compile as before). A tile of
// kKeys keys gives each of kKeys / 16 warps its own 16 keys; where that
// leaves warps over (32-key tiles), the warps that share 16 keys split the
// head dim of P V between them and compute the same logits. The soft cap and
// ALiBi are template switches, so an instance without them pays nothing; the
// mask is a uniform branch taken only on the tiles the policy cannot show to
// be wholly visible. At the end the block merges its warps' states in shared
// memory (the ring's space).
#pragma once

#include "attn_common.cuh"
#include "mma_common.cuh"

namespace split {

constexpr int kWarps = 4;  // warps a block of a split kernel
constexpr int kThreads = kWarps * 32;

// Tiles of the split that starts at tile ta: tiles_per_split, fewer at the
// request's end, none past it; the last split takes all the rest, so that a
// plan made from too low a bound on the context costs speed, never keys.
__device__ __forceinline__ int my_tiles(int n, int ta, int tiles_per_split,
                                        int split, int splits) {
  const int end = split == splits - 1 ? n : min(ta + tiles_per_split, n);
  return max(end - ta, 0);
}

// Writes the block's state of one row: acc [hd] at part_acc[row, split], m
// and l at part_m/part_l[row, split], row = r * nq + h * group + g.
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

// Merge of W per-warp states in shared memory (acc [W][16][pitch], m and
// l [W][16], pitch 16 rows) into the block's state of `group` rows and hd
// columns, written to the scratch.
__device__ __forceinline__ void merge_warps(const float* acc_w,
                                            const float* m_w,
                                            const float* l_w, int n_warps,
                                            int group, int hd, int pitch,
                                            size_t row0, int split,
                                            int splits, float* part_acc,
                                            float* part_m, float* part_l) {
  for (int i = threadIdx.x; i < group * pitch; i += blockDim.x) {
    const int g = i / pitch, d = i - g * pitch;
    if (d >= hd) continue;  // a padded column
    float m = -INFINITY;
    for (int w = 0; w < n_warps; ++w) m = fmaxf(m, m_w[w * 16 + g]);
    float acc = 0.f, l = 0.f;
    if (m != -INFINITY) {
      for (int w = 0; w < n_warps; ++w) {
        const float mw = m_w[w * 16 + g];
        if (mw == -INFINITY) continue;
        const float c = expf(mw - m);
        acc += acc_w[((size_t)w * 16 + g) * pitch + d] * c;
        l += l_w[w * 16 + g] * c;
      }
    }
    write_state(part_acc, part_m, part_l, row0 + g, split, splits, hd, d,
                acc, m, l);
  }
}

// The merge of one query row (r * nq + query head), run by a block: the
// init state (kCascade), then the splits in order, each scaled to the
// common max; out = acc / max(l, 1e-20). States with m = -inf add nothing,
// so a row no state covers gives 0.
template <typename T, bool kCascade>
__device__ __forceinline__ void merge_row(
    size_t row, const float* __restrict__ part_acc,
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    T* __restrict__ out, const float* __restrict__ acc0,
    const float* __restrict__ m0, const float* __restrict__ l0, int hd,
    int splits) {
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

// Geometry of a tensor-core split block: kKeys keys a tile in a ring of 2
// stages (and, for an fp8 cache KV, a ring of 2 stages of its staged
// bytes); after the loop the ring holds the warps' states (acc
// [kKeyWarps][16][HD], m and l [kKeyWarps][16]).
template <int HD, int KEYS, typename KV>
struct TcCfg {
  static constexpr int kKeys = KEYS;
  static constexpr int kKeyWarps = KEYS / 16;            // warps along keys
  static constexpr int kDimWarps = kWarps / kKeyWarps;   // along P V's dims
  static constexpr int kPitch = HD + 8;         // 16-bit elements a row
  static constexpr bool kQInRegs = HD <= 128;
  static constexpr int kRing = (16 + 2 * 2 * KEYS) * kPitch * 2;
  static constexpr int kSmem =
      kRing + (attn::is_fp8<KV> ? 2 * 2 * KEYS * HD : 0);
  static_assert(kKeyWarps * kDimWarps == kWarps, "warps tile the block");
  static_assert(kKeyWarps * 16 * HD * 4 + 2 * kKeyWarps * 16 * 4 <=
                    2 * 2 * KEYS * kPitch * 2,
                "the warps' states fit the ring");
};

// One block's split on the tensor cores. Rows row0 .. row0 + group - 1 of
// q [*, hd] (of T: __nv_bfloat16 or __half; group at most 16, one mma
// tile: a larger group is cut into slices of 16 rows by the caller) are
// the queries; the block walks n_my tiles, tile it of its split. HD is the
// tiles' width, hd (a multiple of 16, at most HD) the model's head_dim:
// the copies of Q, K and V past hd are zero-filled (the products over the
// padded columns add zeros) and the state's padded columns not written, so
// the loops keep their compile-time bounds and an instance at hd == HD (the
// window kernel's, always) compiles as before. Keys (a policy object)
// answers, for key j of tile it:
//   bool fp8(it): the tile's rows are fp8 of type KV (staged and
//     converted), else 16-bit;
//   bool recast(it): the 16-bit rows are bf16 under fp16 queries
//     (converted in place);
//   bool kv(it, j, const uint8_t** k, const uint8_t** v): the first bytes
//     of its K and V rows (hd values each), or false where the key is
//     hidden (it is then not read: zeros);
//   bool full(it): every key of the tile is visible (the mask is skipped);
//   bool visible(it, j): whether the key is visible;
//   int rel_pos(it, j): its position less the query's (needed by kAlibi
//     instances only).
// Softmax units: the raw logit q.k (scale folded into the exponent) in the
// plain instance, the scaled logit with a soft cap or ALiBi. slopes: the
// group's ALiBi slopes (kAlibi).
template <typename T, int HD, int KEYS, bool kCap, bool kAlibi, typename KV,
          class Keys>
__device__ __forceinline__ void tc_split(
    const T* __restrict__ q, size_t row0, int group, int hd, int n_my,
    float scale, float soft_cap, const float* __restrict__ slopes,
    const Keys& keys, float* __restrict__ part_acc,
    float* __restrict__ part_m, float* __restrict__ part_l, int split,
    int splits, uint4* smem) {
  using namespace mma;
  using C = TcCfg<HD, KEYS, KV>;
  constexpr int P = C::kPitch, CPR = HD / 8;
  constexpr int DW = HD / C::kDimWarps;  // head dims of a warp's P V
  const int cpr = hd / 8;  // 16-byte copies of a row's hd columns
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int kw = warp % C::kKeyWarps, dw = warp / C::kKeyWarps;
  constexpr bool kScaled = kCap || kAlibi;
  const float mult = (kScaled ? 1.f : scale) * 1.4426950408889634f;
  const float cap_scale = kCap ? (kAlibi ? 1.f : scale) / soft_cap : 0.f;
  float slope_a = 0.f, slope_b = 0.f;  // rows gq and gq + 8
  if constexpr (kAlibi) {
    if (gq < group) slope_a = slopes[gq];
    if (gq + 8 < group) slope_b = slopes[gq + 8];
  }

  T* q_s = reinterpret_cast<T*>(smem);  // [16, P]
  T* kv_s = q_s + 16 * P;               // [2 stages][K, V][KEYS, P]
  // [2 stages][K, V][KEYS, HD] staged fp8 bytes (an fp8 KV only).
  uint8_t* stg = reinterpret_cast<uint8_t*>(smem) + C::kRing;

  for (int i = tid; i < 16 * CPR; i += kThreads) {
    const int g = i / CPR, c = i - g * CPR;
    const bool ok = g < group && c < cpr;
    cp_async16(q_s + g * P + c * 8, ok ? q + (row0 + g) * hd + c * 8 : q, ok);
  }
  // Tile it into stage `stage` (an fp8 tile: its bytes into the staging
  // ring's stage); hidden keys, and copies past hd, are not read (zeros).
  // Copy c of a row is its bytes [16 c, 16 c + 16).
  auto load_tile = [&](int it, int stage) {
    const uint8_t *ksrc = nullptr, *vsrc = nullptr;
    if (attn::is_fp8<KV> && keys.fp8(it)) {
      uint8_t* kb = stg + (size_t)stage * 2 * KEYS * HD;
#pragma unroll
      for (int u = 0; u < KEYS * HD / 16 / kThreads; ++u) {
        const int i = tid + u * kThreads;
        const int j = i / (HD / 16), c = i - j * (HD / 16);
        const bool ok = keys.kv(it, j, &ksrc, &vsrc) && 2 * c < cpr;
        cp_async16(kb + j * HD + c * 16, ok ? ksrc + c * 16 : (const void*)q,
                   ok);
        cp_async16(kb + (KEYS + j) * HD + c * 16,
                   ok ? vsrc + c * 16 : (const void*)q, ok);
      }
      return;
    }
    T* ks = kv_s + (size_t)stage * 2 * KEYS * P;
    T* vs = ks + KEYS * P;
#pragma unroll
    for (int u = 0; u < KEYS * CPR / kThreads; ++u) {
      const int i = tid + u * kThreads;
      const int j = i / CPR, c = i - j * CPR;
      const bool ok = keys.kv(it, j, &ksrc, &vsrc) && c < cpr;
      cp_async16(ks + j * P + c * 8, ok ? ksrc + c * 16 : (const void*)q, ok);
      cp_async16(vs + j * P + c * 8, ok ? vsrc + c * 16 : (const void*)q, ok);
    }
  };

  uint32_t qf[C::kQInRegs ? HD / 16 : 1][4];
  float o[DW / 8][4];
#pragma unroll
  for (int d = 0; d < DW / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const T* q_w = q_s + (lane & 15) * P + (lane >> 4) * 8;

  if (n_my > 0) load_tile(0, 0);
  cp_async_commit();  // with Q
  for (int it = 0; it < n_my; ++it) {
    cp_async_wait<0>();  // tile it has landed
    __syncthreads();     // and tile it - 1 is consumed
    // Block-uniform: the tile's bytes to convert, or its bf16 to recast.
    const bool staged = attn::is_fp8<KV> && keys.fp8(it);
    const bool recast = !staged && keys.recast(it);
    if (staged)
      attn::convert_rows<KV, HD, T>(stg + (size_t)(it & 1) * 2 * KEYS * HD,
                                    kv_s + (size_t)(it & 1) * 2 * KEYS * P,
                                    2 * KEYS, P, tid, kThreads);
    if (recast)
      attn::bf16_rows_to_f16<HD>(kv_s + (size_t)(it & 1) * 2 * KEYS * P,
                                 2 * KEYS, P, tid, kThreads);
    if (it + 1 < n_my) load_tile(it + 1, (it + 1) & 1);
    cp_async_commit();
    if (staged || recast) __syncthreads();  // the converted tile is whole
    if constexpr (C::kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < HD / 16; ++kc) ldmatrix_x4(qf[kc], q_w + kc * 16);
      }
    }
    // This warp's 16 keys of the tile.
    const T* ks = kv_s + (size_t)(it & 1) * 2 * KEYS * P + kw * 16 * P;
    const T* vs = ks + KEYS * P;
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
      mma16816<T>(s[0], a, b);
      mma16816<T>(s[1], a, b + 2);
    }
    // ALiBi on the scaled logit, then the soft cap, then the mask: one
    // query position for every row, so the mask depends on the key only.
    if constexpr (kAlibi) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float rel =
              (float)keys.rel_pos(it, kw * 16 + nt * 8 + 2 * tq + e);
          s[nt][e] = fmaf(s[nt][e], scale, slope_a * rel);
          s[nt][e + 2] = fmaf(s[nt][e + 2], scale, slope_b * rel);
        }
    }
    if constexpr (kCap) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = soft_cap * tanhf(s[nt][e] * cap_scale);
    }
    if (!keys.full(it)) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (!keys.visible(it, kw * 16 + nt * 8 + 2 * tq + e))
            s[nt][e] = s[nt][e + 2] = -INFINITY;
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
    a[0] = pack<T>(s[0][0], s[0][1]);  // P rounded to T
    a[1] = pack<T>(s[0][2], s[0][3]);
    a[2] = pack<T>(s[1][0], s[1][1]);
    a[3] = pack<T>(s[1][2], s[1][3]);
#pragma unroll
    for (int dp = 0; dp < DW / 16; ++dp) {
      o[2 * dp][0] *= al_a;
      o[2 * dp][1] *= al_a;
      o[2 * dp][2] *= al_b;
      o[2 * dp][3] *= al_b;
      o[2 * dp + 1][0] *= al_a;
      o[2 * dp + 1][1] *= al_a;
      o[2 * dp + 1][2] *= al_b;
      o[2 * dp + 1][3] *= al_b;
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + (lane & 15) * P + dw * DW + dp * 16 +
                               (lane >> 4) * 8);
      mma16816<T>(o[2 * dp], a, b);
      mma16816<T>(o[2 * dp + 1], a, b + 2);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' states

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o_);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o_);
  }
  float* acc_w = reinterpret_cast<float*>(kv_s);  // [kKeyWarps][16][HD]
  float* m_w = acc_w + C::kKeyWarps * 16 * HD;    // [kKeyWarps][16]
  float* l_w = m_w + C::kKeyWarps * 16;           // [kKeyWarps][16]
  float* aw = acc_w + (size_t)kw * 16 * HD + dw * DW;
#pragma unroll
  for (int d = 0; d < DW / 8; ++d) {
    const int col = d * 8 + 2 * tq;
    aw[gq * HD + col] = o[d][0];
    aw[gq * HD + col + 1] = o[d][1];
    aw[(gq + 8) * HD + col] = o[d][2];
    aw[(gq + 8) * HD + col + 1] = o[d][3];
  }
  if (dw == 0 && tq == 0) {  // m in the scaled logit's units
    const float to_scaled = mult * 0.6931471805599453f;
    m_w[kw * 16 + gq] = m_a * to_scaled;
    l_w[kw * 16 + gq] = l_a;
    m_w[kw * 16 + gq + 8] = m_b * to_scaled;
    l_w[kw * 16 + gq + 8] = l_b;
  }
  __syncthreads();
  merge_warps(acc_w, m_w, l_w, C::kKeyWarps, group, hd, HD, row0, split,
              splits, part_acc, part_m, part_l);
}

}  // namespace split
