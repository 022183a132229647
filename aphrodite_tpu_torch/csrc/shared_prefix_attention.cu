// Shared-prefix (cascade) attention (CUDA, sm_90a).
//
// Replaces the TPU kernel `shared_prefix_attention` / `_spa_kernel` of
// aphrodite_tpu/ops/cascade_attention.py. When every request of a decode
// window holds the same leading KV pages (prefix caching dedups them), this
// pass attends all R * group query rows of each KV head to the S shared
// tokens once for the whole batch, with no causal mask (every query sits
// past the prefix), and writes the unnormalized online-softmax state: acc
// [R, kvh, group, hd], m and l [R, kvh, group], fp32. The window kernel
// starts each request from that state and reads only the keys past S. With
// S = 0 a row gets m = -inf, l = 0 and acc = 0.
//
// Bound. At the Llama-3.1-8B cascade path (R 128, 32 / 8 heads of 128, S =
// 1024, bf16) a launch reads 4 MB of K/V and 1 MB of q and writes 2 MB of
// state, ~2.2 us at 3.35 TB/s, and does 2.1 GFLOP, ~2.2 us on the bf16
// tensor cores: per KV head a dense [R * group, hd] x [hd, S] product.
//
// spa_tc_kernel (bf16 and fp16 at head_dim 64, 128 and 256):
// FlashAttention-2 on mma.sync m16n8k16, q's dtype a template parameter
// (fp16's products f32.f16.f16.f32, P rounded to fp16 as the TPU kernel
// rounds it to V's dtype). A block is 4 warps of 16 query rows, 64 rows of one
// KV head, and one split of the shared keys; two blocks share an SM. Q is
// staged once by cp.async and its A fragments re-read by ldmatrix every
// tile (in registers they gained nothing); K and V come in tiles of 64 keys
// (32 at head_dim 256) by 16-byte cp.async into a ring of 2 stages (3 at
// head_dim 64), each thread finding its key row's page in shared_pages.
// The softmax takes base-2 exponents with the scale folded in, m and l in
// registers, and only the last, partial tile takes the mask. 64-row blocks
// over 8 KV heads give 64 blocks at the cascade path, so the keys are
// split too: the host plan (ops/cascade_attention.py: shared_split_plan)
// picks whole tiles a split so that the card gets about two blocks an SM,
// at least two tiles a split. With one split a block writes its state;
// with more, each writes it to a scratch buffer and the last block of a
// (row tile, KV head) to finish (a counter, as the split-K fix-up of
// csrc/quant_matmul.cu) merges the splits in split order: no float
// atomics, so a run is deterministic. m is written in natural-exp units.
//
// An fp8 cache (template type KV, e4m3fn or e5m2; a chat batch on an fp8
// cache takes this pass): the TPU kernel upcasts each K/V tile to q's dtype
// before both products (:87-89). spa_tc_kernel stages an fp8 tile's bytes
// in a ring of its own and converts them into the bf16 tile in shared
// memory (attn::convert_rows); spa_kernel converts to fp32 as it stages,
// loading 8 bytes a vector. The bytes bound halves.
//
// spa_kernel (fp32, and bf16 or fp16 at MLA's head_dim 576, which has no
// tensor-core instance): the first version on the CUDA cores in full fp32,
// so that the fp32 parity paths stay token-exact. A block of 8 warps runs one
// (tile of 32 query rows, KV head); a warp owns 4 rows and keeps their acc
// in registers (lane d holds dims d, d + 32, ...) with their m and l. The
// shared tokens are walked in tiles of min(page, 32) keys, staged once a
// block in shared memory as fp32: K transposed [hd][33], so that lane j
// (key j) reads its column without bank conflicts, and V [32][hd + 1]. The
// next tile's K and V are loaded into registers while the block computes
// on this one: thread i takes 16 bytes of key i % 32, so that its stores
// into both tiles, one key a lane, hit 32 banks.
#include "attn_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;                      // query rows a warp
constexpr int kBlockRows = kWarps * kRows;    // query rows a block
constexpr int kThreads = kWarps * 32;

template <typename T, typename KV, int C>  // C = hd / 32
__global__ void __launch_bounds__(kThreads)
spa_kernel(const T* __restrict__ q, const KV* __restrict__ cache,
           const int* __restrict__ shared_pages, int shared_len,
           float* __restrict__ acc_out, float* __restrict__ m_out,
           float* __restrict__ l_out, int num_reqs, int nq, int kvh,
           int page_size, float scale) {
  using namespace attn;
  constexpr int hd = 32 * C;
  constexpr int KP = kTile + 1;  // pitch of the transposed K tile
  const int h = blockIdx.y;
  const int group = nq / kvh, rows = num_reqs * group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kBlockRows;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBlockRows][hd]
  float* kt_s = q_s + kBlockRows * hd;           // [hd][KP]
  float* v_s = kt_s + hd * KP;                   // [kTile][hd + 1]
  float* p_s = v_s + kTile * (hd + 1) + warp * kRows * kTile;  // [kRows][32]

  // Block row i is query head h * group + (row0 + i) % group of request
  // (row0 + i) / group: the [R, nq, hd] offset of row i is row_off(i) * hd.
  auto row_off = [&](int row) {
    return (size_t)(row / group) * nq + h * group + row % group;
  };
  for (int i = threadIdx.x; i < kBlockRows * hd; i += blockDim.x) {
    const int row = row0 + i / hd;
    q_s[i] = row < rows ? to_float(q[row_off(row) * hd + i % hd]) : 0.f;
  }

  float acc[kRows][C], m[kRows], l[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[rr][c] = 0.f;
  }
  const float* q_w = q_s + warp * kRows * hd;
  const int tile = min(page_size, kTile);
  const int n_tiles = (shared_len + tile - 1) / tile;
  const size_t page_elems = (size_t)page_size * hd;
  // A tile's K and V in vectors of kVec values (16 bytes; 8 for fp8, so
  // that head_dim 64 still gives every thread whole vectors), kLoads a
  // thread: vector i is dims [kVec (i / 32), kVec (i / 32 + 1)) of key
  // i % 32.
  using Vec = typename std::conditional<sizeof(KV) == 1, uint2, uint4>::type;
  constexpr int kVec = sizeof(Vec) / sizeof(KV);
  constexpr int kLoads = kTile * hd / kVec / kThreads;
  static_assert(kLoads * kThreads * kVec == kTile * hd, "whole vectors");
  Vec k_reg[kLoads], v_reg[kLoads];
  const int j_ld = threadIdx.x % kTile;  // the key this thread moves
  auto load_tile = [&](int t) {  // tile t's keys into registers
    const int kv0 = t * tile, n = min(tile, shared_len - kv0);
    if (j_ld >= n) return;
    const int page_id = shared_pages[kv0 / page_size];
    const size_t row = ((size_t)page_id * 2 * kvh + h) * page_elems +
                       (size_t)(kv0 % page_size + j_ld) * hd;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int d0 = kVec * ((threadIdx.x + u * kThreads) / kTile);
      k_reg[u] = __ldg(reinterpret_cast<const Vec*>(cache + row + d0));
      v_reg[u] = __ldg(reinterpret_cast<const Vec*>(
          cache + row + kvh * page_elems + d0));
    }
  };
  if (n_tiles > 0) load_tile(0);
  for (int t = 0; t < n_tiles; ++t) {
    const int n = min(tile, shared_len - t * tile);
    __syncthreads();  // the previous tile is consumed; q is staged
    if (j_ld < n) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const KV* kv = reinterpret_cast<const KV*>(&k_reg[u]);
        const KV* vv = reinterpret_cast<const KV*>(&v_reg[u]);
        const int d0 = kVec * ((threadIdx.x + u * kThreads) / kTile);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          kt_s[(d0 + e) * KP + j_ld] = to_float(kv[e]);
          v_s[j_ld * (hd + 1) + d0 + e] = to_float(vv[e]);
        }
      }
    }
    __syncthreads();
    if (t + 1 < n_tiles) load_tile(t + 1);

    float s[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) s[rr] = 0.f;
    if (lane < n) {
#pragma unroll 4
      for (int d = 0; d < hd; d += 4) {
        const float k0 = kt_s[d * KP + lane], k1 = kt_s[(d + 1) * KP + lane];
        const float k2 = kt_s[(d + 2) * KP + lane];
        const float k3 = kt_s[(d + 3) * KP + lane];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const float4 qv =
              *reinterpret_cast<const float4*>(q_w + rr * hd + d);
          s[rr] = fmaf(qv.w, k3,
                       fmaf(qv.z, k2, fmaf(qv.y, k1, fmaf(qv.x, k0, s[rr]))));
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const float sv = lane < n ? s[rr] * scale : -INFINITY;
      const float m_new = fmaxf(m[rr], warp_max(sv));  // finite: n >= 1
      const float p = lane < n ? expf(sv - m_new) : 0.f;
      const float alpha = m[rr] == -INFINITY ? 0.f : expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = m_new;
      p_s[rr * kTile + lane] = p;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[rr][c] *= alpha;
    }
    __syncwarp();
    for (int j = 0; j < n; ++j) {
      float v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = v_s[j * (hd + 1) + lane + 32 * c];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float p = p_s[rr * kTile + j];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[rr][c] = fmaf(p, v[c], acc[rr][c]);
      }
    }
    __syncwarp();  // p_s is read before the next tile rewrites it
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int row = row0 + warp * kRows + rr;
    if (row >= rows) break;
    const size_t o = row_off(row);
#pragma unroll
    for (int c = 0; c < C; ++c) acc_out[o * hd + lane + 32 * c] = acc[rr][c];
    if (lane == 0) {
      m_out[o] = m[rr];
      l_out[o] = l[rr];
    }
  }
}

// ------------------------------------------ tensor-core kernel (bf16, fp16)
constexpr int kMaxSplits = 32;  // the merge keeps a factor a (split, row)

// 4 warps of 16 query rows; two blocks share an SM. An fp8 cache adds a
// ring of staged bytes.
template <int HD, typename KV>
struct SpaCfg {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kRows = kWarps * 16;            // query rows a block
  static constexpr int kKeys = HD <= 128 ? 64 : 32;    // keys a tile
  static constexpr int kPitch = HD + 8;                // 16-bit elements a row
  static constexpr int kStages = HD <= 64 ? 3 : 2;
  static constexpr int kRing = (kRows + kStages * 2 * kKeys) * kPitch * 2;
  static constexpr int kSmem =
      kRing + (attn::is_fp8<KV> ? kStages * 2 * kKeys * HD : 0);
  static_assert(kRows * (1 + kMaxSplits) * 4 <=
                    kStages * 2 * kKeys * kPitch * 2,
                "the merge's factors fit the ring");
};

template <typename T, int HD, typename KV>
__global__ void __launch_bounds__(128, 2)
spa_tc_kernel(const T* __restrict__ q,
              const KV* __restrict__ cache,
              const int* __restrict__ shared_pages, int shared_len,
              float* __restrict__ acc_out, float* __restrict__ m_out,
              float* __restrict__ l_out, float* __restrict__ part,
              int* __restrict__ counters, int num_reqs, int nq, int kvh,
              int page_size, float scale, int tiles_per_split) {
  using namespace mma;
  using C = SpaCfg<HD, KV>;
  constexpr bool kFp8 = attn::is_fp8<KV>;
  constexpr int BN = C::kKeys, P = C::kPitch, CPR = HD / 8;
  // 16-byte copies a K (or V) row takes: 8 16-bit or 16 fp8 values each.
  constexpr int KCPR = kFp8 ? HD / 16 : CPR;
  constexpr int NT = BN / 8, DT = HD / 8;  // n-tiles of S and of O
  const int h = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int group = nq / kvh, rows = num_reqs * group;
  const int row0 = blockIdx.x * C::kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t page_elems = (size_t)page_size * HD;
  const int page_shift = __popc(page_size) == 1 ? __ffs(page_size) - 1 : -1;
  const float mult = scale * 1.4426950408889634f;  // raw logit -> log2
  // Block row i is query head h * group + (row0 + i) % group of request
  // (row0 + i) / group: the [R, nq, hd] offset of row i is row_off(i) * hd.
  auto row_off = [&](int row) {
    return (size_t)(row / group) * nq + h * group + row % group;
  };

  extern __shared__ uint4 smem_spa[];
  T* q_s = reinterpret_cast<T*>(smem_spa);  // [64, P]
  T* kv_s = q_s + C::kRows * P;              // [stages][K, V][BN, P]
  // fp8: [stages][K, V][BN, HD] bytes, converted into kv_s's stage.
  uint8_t* stg = reinterpret_cast<uint8_t*>(smem_spa) + C::kRing;

  for (int i = tid; i < C::kRows * CPR; i += C::kThreads) {
    const int r = i / CPR, c = i - r * CPR, row = row0 + r;
    const bool ok = row < rows;
    cp_async16(q_s + r * P + c * 8, ok ? q + row_off(row) * HD + c * 8 : q,
               ok);
  }
  const int n_tiles = (shared_len + BN - 1) / BN;
  const int ta = split * tiles_per_split;
  const int n_my =
      split == splits - 1 ? max(n_tiles - ta, 0)
                          : max(min(ta + tiles_per_split, n_tiles) - ta, 0);
  // Tile ta + it into ring stage `stage` (fp8: its staged bytes); keys
  // at or past S are zero. Copy c of a row is its bytes [16 c, 16 c + 16).
  auto load_tile = [&](int it, int stage) {
    T* ks = kv_s + (size_t)stage * 2 * BN * P;
    uint8_t* kb = stg + (size_t)stage * 2 * BN * HD;
#pragma unroll
    for (int u = 0; u < BN * KCPR / C::kThreads; ++u) {
      const int i = tid + u * C::kThreads;
      const int j = i / KCPR, c = i - j * KCPR;
      const int pos = (ta + it) * BN + j;
      const bool ok = pos < shared_len;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(q);
      const uint8_t* vsrc = src;
      if (ok) {
        const int pg = page_shift >= 0 ? pos >> page_shift : pos / page_size;
        const KV* kr = cache +
                       ((size_t)shared_pages[pg] * 2 * kvh + h) * page_elems +
                       (size_t)(pos - pg * page_size) * HD;
        src = reinterpret_cast<const uint8_t*>(kr) + c * 16;
        vsrc = reinterpret_cast<const uint8_t*>(kr + kvh * page_elems) +
               c * 16;
      }
      if constexpr (kFp8) {
        cp_async16(kb + j * HD + c * 16, src, ok);
        cp_async16(kb + (BN + j) * HD + c * 16, vsrc, ok);
      } else {
        cp_async16(ks + j * P + c * 8, src, ok);
        cp_async16(ks + (BN + j) * P + c * 8, vsrc, ok);
      }
    }
  };

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  // ldmatrix addresses: A (Q rows, re-read every tile: kept in registers
  // they gain nothing) and B of K (row-major) and V (.trans).
  const T* q_w = q_s + (warp * 16 + (lane & 15)) * P + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8;
  const int v_off = (lane & 15) * P + (lane >> 4) * 8;

#pragma unroll
  for (int st = 0; st < C::kStages - 1; ++st) {
    if (st < n_my) load_tile(st, st);
    cp_async_commit();  // group 0 holds Q too
  }
  for (int it = 0; it < n_my; ++it) {
    cp_async_wait<C::kStages - 2>();  // tile it has landed
    __syncthreads();                  // and tile it - 1 is consumed
    if constexpr (kFp8)  // its bytes into the stage's tile of T
      attn::convert_rows<KV, HD, T>(
          stg + (size_t)(it % C::kStages) * 2 * BN * HD,
          kv_s + (size_t)(it % C::kStages) * 2 * BN * P, 2 * BN, P, tid,
          C::kThreads);
    {
      const int nx = it + C::kStages - 1;
      if (nx < n_my) load_tile(nx, nx % C::kStages);
      cp_async_commit();
    }
    if constexpr (kFp8) __syncthreads();  // the converted tile is whole
    const T* ks = kv_s + (size_t)(it % C::kStages) * 2 * BN * P;
    const T* vs = ks + BN * P;

    // S = Q K^T for the warp's rows and the tile's keys.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t a[4];
      ldmatrix_x4(a, q_w + kc * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + np * 16 * P + kc * 16 + k_off);
        mma16816<T>(s[2 * np], a, b);
        mma16816<T>(s[2 * np + 1], a, b + 2);
      }
    }
    // Only the last tile can hold keys past S (uniform branch).
    const int kv0 = (ta + it) * BN;
    if (kv0 + BN > shared_len) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + j * 8 + 2 * tq + (e & 1) >= shared_len)
            s[j][e] = -INFINITY;
    }

    // Online softmax of rows g (c0, c1) and g + 8 (c2, c3); a lane quad
    // holds one row's keys. m in raw logit units, exponents base 2.
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m_r[hf], mx);  // finite: a tile has a key
      const float base = mn * mult;
      const float alpha = fast_exp2(m_r[hf] * mult - base);
      m_r[hf] = mn;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][2 * hf] = fast_exp2(fmaf(s[j][2 * hf], mult, -base));
        s[j][2 * hf + 1] = fast_exp2(fmaf(s[j][2 * hf + 1], mult, -base));
        rs += s[j][2 * hf] + s[j][2 * hf + 1];
      }
      l_r[hf] = l_r[hf] * alpha + rs;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][2 * hf] *= alpha;
        o[d][2 * hf + 1] *= alpha;
      }
    }

    // O += P V: P's accumulators are the A fragments of 16-key chunks.
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack<T>(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack<T>(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack<T>(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack<T>(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + kc * 16 * P + dp * 16 + v_off);
        mma16816<T>(o[2 * dp], a, b);
        mma16816<T>(o[2 * dp + 1], a, b + 2);
      }
    }
  }
  cp_async_wait<0>();

  // This split's state: to the outputs with one split, else to the
  // scratch [split][kvh][rows] (acc, then m, then l), m in natural units.
  const size_t n_state = (size_t)kvh * rows;
  float* part_m = part + (size_t)splits * n_state * HD;
  float* part_l = part_m + (size_t)splits * n_state;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = l_r[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + warp * 16 + hf * 8 + gq;
    if (row >= rows) continue;
    size_t st = row_off(row);
    float* acc = acc_out;
    float *mp = m_out, *lp = l_out;
    if (splits > 1) {
      st = ((size_t)split * kvh + h) * rows + row;
      acc = part;
      mp = part_m;
      lp = part_l;
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(acc + st * HD + d * 8 + 2 * tq) =
          make_float2(o[d][2 * hf], o[d][2 * hf + 1]);
    if (tq == 0) {
      mp[st] = m_r[hf] * scale;
      lp[st] = l;
    }
  }
  if (splits == 1) return;

  // The last block of this (row tile, KV head) to finish merges the splits
  // in split order and resets the tile's counter for the next launch.
  __shared__ int is_last;
  __threadfence();  // this block's state is visible device-wide
  __syncthreads();  // (and every warp is done with the ring)
  int* counter = counters + (size_t)h * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float* c_s = reinterpret_cast<float*>(kv_s);  // [splits][64] factors
  for (int r = tid; r < C::kRows; r += C::kThreads) {
    const int row = row0 + r;
    if (row >= rows) continue;
    float m = -INFINITY;
    for (int sp = 0; sp < splits; ++sp)
      m = fmaxf(m, __ldcg(part_m + ((size_t)sp * kvh + h) * rows + row));
    float l = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const size_t st = ((size_t)sp * kvh + h) * rows + row;
      const float ms = __ldcg(part_m + st);
      const float c = ms == -INFINITY ? 0.f : expf(ms - m);
      c_s[sp * C::kRows + r] = c;
      l += __ldcg(part_l + st) * c;
    }
    m_out[row_off(row)] = m;
    l_out[row_off(row)] = l;
  }
  __syncthreads();
  // acc: each thread owns kE float4s of the tile, kChunk at a time, and
  // walks the splits with kChunk loads in flight.
  constexpr int kE = C::kRows * HD / 4 / C::kThreads;
  constexpr int kChunk = kE < 8 ? kE : 8;
  static_assert(kE % kChunk == 0, "whole chunks");
#pragma unroll 1
  for (int e0 = 0; e0 < kE; e0 += kChunk) {
    float4 v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < splits; ++sp) {
      const float* base = part + ((size_t)sp * kvh + h) * rows * HD;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int i = tid + (e0 + k) * C::kThreads;
        const int r = i / (HD / 4), d = 4 * (i - r * (HD / 4));
        if (row0 + r >= rows) continue;
        const float c = c_s[sp * C::kRows + r];
        const float4 p = __ldcg(reinterpret_cast<const float4*>(
            base + (size_t)(row0 + r) * HD + d));
        v[k].x = fmaf(p.x, c, v[k].x);
        v[k].y = fmaf(p.y, c, v[k].y);
        v[k].z = fmaf(p.z, c, v[k].z);
        v[k].w = fmaf(p.w, c, v[k].w);
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int i = tid + (e0 + k) * C::kThreads;
      const int r = i / (HD / 4), d = 4 * (i - r * (HD / 4));
      if (row0 + r < rows)
        *reinterpret_cast<float4*>(acc_out + row_off(row0 + r) * HD + d) =
            v[k];
    }
  }
  if (tid == 0) *counter = 0;
}

template <typename T, int HD, typename KV>
int launch_tc(const void* q, const void* cache, const int* shared_pages,
              int shared_len, float* acc, float* m, float* l, float* part,
              int* counters, int num_reqs, int nq, int kvh, int page_size,
              float scale, int splits, int tiles_per_split,
              cudaStream_t stream) {
  using C = SpaCfg<HD, KV>;
  const cudaError_t err =
      mma::allow_smem<spa_tc_kernel<T, HD, KV>>(C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int rows = num_reqs * (nq / kvh);
  const dim3 grid((rows + C::kRows - 1) / C::kRows, kvh, splits);
  spa_tc_kernel<T, HD, KV><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(cache),
      shared_pages, shared_len,
      acc, m, l, part, counters, num_reqs, nq, kvh, page_size, scale,
      tiles_per_split);
  return (int)cudaGetLastError();
}

template <typename T, typename KV, int C>
int launch_c(const void* q, const void* cache, const int* shared_pages,
             int shared_len, float* acc, float* m, float* l, int num_reqs,
             int nq, int kvh, int page_size, float scale, int smem_bytes,
             cudaStream_t stream) {
  const cudaError_t err = mma::allow_smem<spa_kernel<T, KV, C>>(smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int rows = num_reqs * (nq / kvh);
  const dim3 grid((rows + kBlockRows - 1) / kBlockRows, kvh);
  spa_kernel<T, KV, C><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(cache), shared_pages,
      shared_len, acc, m, l, num_reqs, nq, kvh, page_size, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int launch(const void* q, const void* cache, const int* shared_pages,
           int shared_len, float* acc, float* m, float* l, int num_reqs,
           int nq, int kvh, int page_size, int hd, float scale,
           int smem_bytes, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_c<T, KV, 2>(q, cache, shared_pages, shared_len, acc, m, l,
                            num_reqs, nq, kvh, page_size, scale, smem_bytes,
                            stream);
    case 128:
      return launch_c<T, KV, 4>(q, cache, shared_pages, shared_len, acc, m, l,
                            num_reqs, nq, kvh, page_size, scale, smem_bytes,
                            stream);
    case 256:
      return launch_c<T, KV, 8>(q, cache, shared_pages, shared_len, acc, m, l,
                            num_reqs, nq, kvh, page_size, scale, smem_bytes,
                            stream);
    case 576:  // MLA's latent head (DeepSeek V2/V3), bf16 included
      return launch_c<T, KV, 18>(q, cache, shared_pages, shared_len, acc, m,
                                 l, num_reqs, nq, kvh, page_size, scale,
                                 smem_bytes, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int HD>
int launch_tc_kv(int kv_dtype, const void* q, const void* cache,
                 const int* shared_pages, int shared_len, float* acc,
                 float* m, float* l, float* part, int* counters, int num_reqs,
                 int nq, int kvh, int page_size, float scale, int splits,
                 int tiles_per_split, cudaStream_t s) {
#define SPA_KV(KV)                                                         \
  return launch_tc<T, HD, KV>(q, cache, shared_pages, shared_len, acc, m, l, \
                              part, counters, num_reqs, nq, kvh, page_size, \
                              scale, splits, tiles_per_split, s)
  if (kv_dtype == kKvAuto) SPA_KV(T);
  if (kv_dtype == kKvE4M3) SPA_KV(__nv_fp8_e4m3);
  if (kv_dtype == kKvE5M2) SPA_KV(__nv_fp8_e5m2);
#undef SPA_KV
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernel for queries of T at head_dim 64, 128 or 256.
template <typename T>
int launch_tc_hd(int kv_dtype, const void* q, const void* cache,
                 const int* shared_pages, int shared_len, float* acc,
                 float* m, float* l, float* part, int* counters, int num_reqs,
                 int nq, int kvh, int page_size, int hd, float scale,
                 int splits, int tiles_per_split, cudaStream_t s) {
#define SPA_HD(HD)                                                          \
  if (hd == HD)                                                             \
    return launch_tc_kv<T, HD>(kv_dtype, q, cache, shared_pages, shared_len, \
                               acc, m, l, part, counters, num_reqs, nq, kvh, \
                               page_size, scale, splits, tiles_per_split, s);
  SPA_HD(64)
  SPA_HD(128)
  SPA_HD(256)
#undef SPA_HD
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_kv(int kv_dtype, const void* q, const void* cache,
              const int* shared_pages, int shared_len, float* acc, float* m,
              float* l, int num_reqs, int nq, int kvh, int page_size, int hd,
              float scale, int smem_bytes, cudaStream_t s) {
#define SPA_KV(KV)                                                        \
  return launch<T, KV>(q, cache, shared_pages, shared_len, acc, m, l,     \
                       num_reqs, nq, kvh, page_size, hd, scale, smem_bytes, \
                       s)
  if (kv_dtype == kKvAuto) SPA_KV(T);
  if (kv_dtype == kKvE4M3) SPA_KV(__nv_fp8_e4m3);
  if (kv_dtype == kKvE5M2) SPA_KV(__nv_fp8_e5m2);
#undef SPA_KV
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [R, nq, hd] (code 0 fp32, 1 bf16, 2 fp16) and the layer's cache [P, 2, kvh,
// page, hd] in q's dtype or fp8 (kv_dtype, a KvDtype code); shared_pages:
// the pages holding the prefix's shared_len tokens, in order. acc [R, nq, hd], m and l [R, nq] fp32.
// tensor_cores: spa_tc_kernel (bf16 or fp16, head_dim 64, 128 or 256) over
// `splits` splits of `tiles_per_split` tiles; with more than one split,
// part holds splits * kvh * R * group * (hd + 2) floats of scratch and
// counters ceil(R * group / 64) * kvh ints, zero before the launch (the
// kernel leaves them zero). Else spa_kernel with smem_bytes (computed by
// the wrapper): q rows [32][hd], K transposed [hd][33], V [32][hd + 1] and
// p [8 warps][4 rows][32], all fp32.
extern "C" int spa_launch(int dtype, int kv_dtype, int tensor_cores,
                          const void* q,
                          const void* cache_layer, const int* shared_pages,
                          int shared_len, float* acc, float* m, float* l,
                          float* part, int* counters, int num_reqs, int nq,
                          int kvh, int page_size, int hd, float scale,
                          int smem_bytes, int splits, int tiles_per_split,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (num_reqs < 1 || kvh < 1 || nq % kvh != 0 || shared_len < 0 ||
      page_size < 1)
    return (int)cudaErrorInvalidValue;
  if (tensor_cores) {
    if (splits < 1 || splits > kMaxSplits || tiles_per_split < 1 ||
        (splits > 1 && (part == nullptr || counters == nullptr)))
      return (int)cudaErrorInvalidValue;
    if (dtype == kBFloat16)
      return launch_tc_hd<__nv_bfloat16>(
          kv_dtype, q, cache_layer, shared_pages, shared_len, acc, m, l,
          part, counters, num_reqs, nq, kvh, page_size, hd, scale, splits,
          tiles_per_split, s);
    if (dtype == kFloat16)
      return launch_tc_hd<__half>(
          kv_dtype, q, cache_layer, shared_pages, shared_len, acc, m, l,
          part, counters, num_reqs, nq, kvh, page_size, hd, scale, splits,
          tiles_per_split, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == kFloat32)
    return launch_kv<float>(kv_dtype, q, cache_layer, shared_pages,
                            shared_len, acc, m, l, num_reqs, nq, kvh,
                            page_size, hd, scale, smem_bytes, s);
  if (dtype == kBFloat16)
    return launch_kv<__nv_bfloat16>(kv_dtype, q, cache_layer, shared_pages,
                                    shared_len, acc, m, l, num_reqs, nq, kvh,
                                    page_size, hd, scale, smem_bytes, s);
  if (dtype == kFloat16)
    return launch_kv<__half>(kv_dtype, q, cache_layer, shared_pages,
                             shared_len, acc, m, l, num_reqs, nq, kvh,
                             page_size, hd, scale, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
