// Decode paged attention (CUDA, sm_90a).
//
// Replaces the TPU kernel `decode_paged_attention` / `_decode_kernel` of
// aphrodite_tpu/ops/decode_paged_attention.py. Each request r has one query
// token at position pos = seq_lens[r] - 1 (its K/V already written to the
// pages); it attends keys 0..pos of the request, read through block_tables
// from one layer of the cache [P, 2, kvh, page, hd]. Options, as in the TPU
// kernel: sliding window, chunked local attention, logit soft cap and ALiBi
// (slope[q head] * (kv_pos - pos), added BEFORE the soft cap as the TPU
// kernel adds it, decode_paged_attention.py:97-110; the JAX oracle adds it
// after, backend.py:170-178). A row with seq_len 0 gives zeros; a fully
// masked row gives 0, never NaN.
//
// Bound. At the Gemma-2-9B decode step (R 32, kvh 8, hd 256, ~545 keys) a
// launch reads ~143 MB of bf16 K/V: bound by bytes, >= 43 us at 3.35 TB/s.
// At BLOOM-3b's step (32 / 32 heads of 80, ALiBi) it reads ~179 MB, >= 53
// us; at MPT-30B's (64 / 64 of 112) ~0.50 GB, >= 149 us; at Falcon-7B's
// (71 query heads of 64 on one KV head) only ~4.5 MB, where the launch is
// bound by how many blocks it can spread over the card's 132 SMs.
//
// dpa_split_tc_kernel (bf16 and fp16 at any head_dim that is a multiple of 16
// up to 256, any group): split-KV on the tensor cores, split::tc_split of
// csrc/split_decode.cuh (shared with the window kernel; q's dtype a template
// parameter, fp16's products f32.f16.f16.f32). A request's visible keys, from
// first_visible(pos) to pos, are cut into tiles (64 keys; 32 at head_dim 256,
// so that the 2-stage ring and Q take ~76 KB and three blocks share an SM) and
// the tiles into splits: grid (request, KV head x row slice, split), split s
// taking tiles [s * tps, (s + 1) * tps) and the last split all the rest, so a
// plan made from too low a bound on the context costs speed, never keys. The
// host plan (ops/decode_paged_attention.py: decode_plan) is made once a decode
// window by the runner. Each split writes its unnormalized state to a scratch
// buffer and dpa_merge_kernel, launched right after it, merges the splits in a
// fixed order. The soft cap and ALiBi are template switches (a runtime option
// once cost ~27 % of a window launch through a spill); only the tiles that hold
// the first visible key or the query take the mask.
//
// Other head dims: the tiles are 64, 128 or 256 wide (the narrowest that
// holds hd; 32-key tiles past 128) and hd a run-time stride, as in the
// ragged kernel (csrc/ragged_paged_attention.cu): the copies past hd are
// zero-filled, so BLOOM-3b's 80 in a 128-wide tile costs shared memory and
// the padded columns' products, not bytes.
// Groups past 16 (one m16n8k16 tile of query rows): the group is cut into
// slices of 16 rows, each slice a block of its own (grid.y = KV head x
// slice), its rows written to the scratch as a whole group's are, so the
// merge needs no change and takes each row's splits in order. The other
// design, several m-tiles a block sharing each staged K/V tile, would
// read K/V once a (request, KV head, split) but needs an O fragment and
// a softmax state per m-tile (five at Falcon-7B: past the three blocks an
// SM that 170 registers a thread allow). The slices re-read the head's
// tiles, from L2 (Falcon-7B's step holds ~4.5 MB of K/V, the L2 50 MB),
// and their blocks count in the split plan (decode_plan), which at
// Falcon-7B's 32 requests x 5 slices gives the card 800 blocks where one
// block a (request, KV head) gave it 32. Phase 2 of chip_smoke.py times
// the slices at Falcon-7B's step beside SDPA and the CUDA-core instance;
// the m-tile design was not built.
//
// An fp8 cache (template type KV, e4m3fn or e5m2; a Gemma model with
// kv_cache_dtype "fp8" decodes here): the TPU kernel upcasts each K/V tile
// to q's dtype before both products (:90-92). The tensor-core split stages
// an fp8 tile's bytes and converts them in shared memory
// (split_decode.cuh); dpa_kernel stages the bytes as words and converts
// each value as it reads it. The bytes bound halves.
//
// dpa_kernel (fp32, and bf16 or fp16 at a head_dim that is not a multiple of
// 16, or past 256): the first version, in full fp32 (tensor cores would take
// fp32 through TF32), so that the fp32 parity paths stay token-exact. One block
// runs one (request, KV head) with its group of query rows; the visible keys
// are cut into tiles of 32 and warp w takes tiles w, w + W, ... with its own
// online-softmax state, merged by the block at the end. Each warp stages its
// tile in its own shared memory in the cache's dtype, as 32-bit words, K rows
// padded by one word so that lane j, reading key j, hits a distinct bank. The
// wrapper picks W (4, else 2, else 1) to fit the card's shared memory and
// passes the bytes; it raises when none fits.
#include "split_decode.cuh"

namespace {

constexpr int kMaxWarps = 4;

// q_row . key, the key a staged row of 32-bit words (of the cache's
// dtype: here fp8, four values a word).
template <typename T>
__device__ __forceinline__ float dot_words(const float* q_row,
                                           const unsigned* k_row, int words) {
  float dot = 0.f;
  for (int w = 0; w < words; ++w) {
    const unsigned u = k_row[w];
    const uint32_t lo = attn::fp8x2_to<T>(u);
    const uint32_t hi = attn::fp8x2_to<T>(u >> 16);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
    dot = fmaf(q_row[4 * w], a.x, dot);
    dot = fmaf(q_row[4 * w + 1], a.y, dot);
    dot = fmaf(q_row[4 * w + 2], b.x, dot);
    dot = fmaf(q_row[4 * w + 3], b.y, dot);
  }
  return dot;
}
template <>
__device__ __forceinline__ float dot_words<float>(const float* q_row,
                                                  const unsigned* k_row,
                                                  int words) {
  float dot = 0.f;
  for (int w = 0; w < words; ++w)
    dot = fmaf(q_row[w], __uint_as_float(k_row[w]), dot);
  return dot;
}
template <>
__device__ __forceinline__ float dot_words<__half>(const float* q_row,
                                                   const unsigned* k_row,
                                                   int words) {
  float dot = 0.f;
  for (int w = 0; w < words; ++w) {
    const unsigned u = k_row[w];
    const float2 k = __half22float2(*reinterpret_cast<const __half2*>(&u));
    dot = fmaf(q_row[2 * w], k.x, dot);
    dot = fmaf(q_row[2 * w + 1], k.y, dot);
  }
  return dot;
}
template <>
__device__ __forceinline__ float dot_words<__nv_bfloat16>(
    const float* q_row, const unsigned* k_row, int words) {
  float dot = 0.f;
  for (int w = 0; w < words; ++w) {
    const unsigned u = k_row[w];
    const float2 k =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
    dot = fmaf(q_row[2 * w], k.x, dot);
    dot = fmaf(q_row[2 * w + 1], k.y, dot);
  }
  return dot;
}

// One warp's online-softmax update of one query row against its staged
// tile (attn::tile_update, with the ALiBi bias and values in T). Lane j owns
// key j; `valid` says whether that key is visible to the row.
template <typename T>
__device__ __forceinline__ void row_update(
    const float* q_row, const unsigned* k_s, const T* v_s, int n, int hd,
    int words, bool valid, float scale, float bias, float soft_cap,
    float* acc_row, float* m, float* l, float* p_w, int lane) {
  using namespace attn;
  float s = -INFINITY;
  if (valid) {
    s = dot_words<T>(q_row, k_s + lane * (words + 1), words) * scale + bias;
    if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
  }
  const float m_prev = *m;
  const float m_new = fmaxf(m_prev, warp_max(s));
  if (m_new == -INFINITY) return;  // no visible key yet (warp-uniform)
  const float p = valid ? expf(s - m_new) : 0.f;
  const float alpha = (m_prev == -INFINITY) ? 0.f : expf(m_prev - m_new);
  const float psum = warp_sum(p);
  p_w[lane] = p;
  __syncwarp();
  for (int d = lane; d < hd; d += 32) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j)
      acc = fmaf(p_w[j], to_float(v_s[j * hd + d]), acc);
    acc_row[d] = acc_row[d] * alpha + acc;
  }
  __syncwarp();
  if (lane == 0) {
    *m = m_new;
    *l = *l * alpha + psum;
  }
  __syncwarp();
}

// Per-warp shared memory, in 32-bit words: K tile [kTile, words + 1], V tile
// [kTile, words], p [kTile], acc [group, hd], m [group], l [group].
struct WarpSmem {
  unsigned* k;
  unsigned* v;
  float* p;
  float* acc;
  float* m;
  float* l;
  __device__ WarpSmem(float* base, int words, int group, int hd) {
    k = reinterpret_cast<unsigned*>(base);
    v = k + attn::kTile * (words + 1);
    p = reinterpret_cast<float*>(v + attn::kTile * words);
    acc = p + attn::kTile;
    m = acc + group * hd;
    l = m + group;
  }
};

template <typename T, typename KV>
__global__ void __launch_bounds__(kMaxWarps * 32)
dpa_kernel(const T* __restrict__ q, const KV* __restrict__ cache,
           T* __restrict__ out, const int* __restrict__ seq_lens,
           const int* __restrict__ block_tables,
           const float* __restrict__ alibi, int max_pages, int nq, int kvh,
           int page_size, int hd, float scale, int sliding_window,
           int chunk_attn, float soft_cap) {
  using namespace attn;
  const int r = blockIdx.x, h = blockIdx.y;
  const int group = nq / kvh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const size_t q_off = ((size_t)r * nq + h * group) * hd;
  const int seq_len = seq_lens[r];
  if (seq_len <= 0) {  // no token: zeros (block-uniform, before any sync)
    for (int i = threadIdx.x; i < group * hd; i += blockDim.x)
      out[q_off + i] = from_float<T>(0.f);
    return;
  }
  const int q_pos = seq_len - 1;
  const int words = hd * (int)sizeof(KV) / 4;  // 32-bit words of a K/V row
  const int tile = min(page_size, kTile);

  extern __shared__ float smem[];
  float* q_s = smem;  // [group, hd]
  const int per_warp =
      kTile * (2 * words + 1) + kTile + group * hd + 2 * group;
  WarpSmem ws(q_s + group * hd + warp * per_warp, words, group, hd);

  for (int i = threadIdx.x; i < group * hd; i += blockDim.x)
    q_s[i] = to_float(q[q_off + i]);
  for (int i = lane; i < group * hd; i += 32) ws.acc[i] = 0.f;
  for (int g = lane; g < group; g += 32) {
    ws.m[g] = -INFINITY;
    ws.l[g] = 0.f;
  }
  __syncthreads();

  const float* slopes = alibi != nullptr ? alibi + h * group : nullptr;
  const size_t page_elems = (size_t)page_size * hd;
  const int t0 = first_visible(q_pos, sliding_window, chunk_attn) / tile;
  const int n_tiles = q_pos / tile + 1 - t0;
  for (int t = warp; t < n_tiles; t += n_warps) {
    const int kv0 = (t0 + t) * tile;
    const int n = min(tile, q_pos + 1 - kv0);
    const int page_id = block_tables[(size_t)r * max_pages + kv0 / page_size];
    const size_t base = ((size_t)page_id * 2 * kvh + h) * page_elems +
                        (size_t)(kv0 % page_size) * hd;
    const unsigned* kb = reinterpret_cast<const unsigned*>(cache + base);
    const unsigned* vb =
        reinterpret_cast<const unsigned*>(cache + base + kvh * page_elems);
    __syncwarp();  // this warp's previous tile fully consumed
    for (int i = lane; i < n * words; i += 32) {
      const int j = i / words;
      ws.k[i + j] = kb[i];  // row j starts at j * (words + 1)
      ws.v[i] = vb[i];
    }
    __syncwarp();
    const int kv_pos = kv0 + lane;
    const bool valid =
        lane < n && local_ok(kv_pos, q_pos, sliding_window, chunk_attn);
    for (int g = 0; g < group; ++g) {
      const float bias =
          slopes != nullptr ? slopes[g] * (float)(kv_pos - q_pos) : 0.f;
      row_update<KV>(q_s + g * hd, ws.k, reinterpret_cast<const KV*>(ws.v), n,
                    hd, words, valid, scale, bias, soft_cap, ws.acc + g * hd,
                    ws.m + g, ws.l + g, ws.p, lane);
    }
  }
  __syncthreads();

  // Merge the warps' online-softmax states.
  for (int i = threadIdx.x; i < group * hd; i += blockDim.x) {
    const int g = i / hd;
    float m = -INFINITY;
    for (int w = 0; w < n_warps; ++w)
      m = fmaxf(m, WarpSmem(q_s + group * hd + w * per_warp, words, group, hd)
                       .m[g]);
    float acc = 0.f, l = 0.f;
    if (m != -INFINITY) {
      for (int w = 0; w < n_warps; ++w) {
        const WarpSmem o(q_s + group * hd + w * per_warp, words, group, hd);
        if (o.m[g] == -INFINITY) continue;
        const float c = expf(o.m[g] - m);
        acc += o.acc[i] * c;
        l += o.l[g] * c;
      }
    }
    out[q_off + i] = from_float<T>(acc / fmaxf(l, 1e-20f));
  }
}

// ------------------------------------------ tensor-core split (bf16, fp16)
// Keys per tile of the tensor-core instance (by the tiles' width HD).
template <int HD>
constexpr int kTcKeys = HD <= 128 ? 64 : 32;

// The decode query's keys for split::tc_split: tile it of the split that
// starts at tile ta holds positions (t0 + ta + it) * KEYS ...; the keys
// from lo (the window's and the chunk's first) to pos are visible. Rows
// of the cache are hd (the model's head_dim) values apart.
template <int KEYS, typename KV>
struct DecodeKeys {
  const KV* cache;
  const int* bt;
  int lo, pos, kv_base, kvh, h, hd, page_size, page_shift;
  size_t page_elems;

  __device__ __forceinline__ int key(int it, int j) const {
    return kv_base + it * KEYS + j;
  }
  __device__ __forceinline__ bool fp8(int) const { return attn::is_fp8<KV>; }
  __device__ __forceinline__ bool recast(int) const { return false; }
  __device__ __forceinline__ bool kv(int it, int j, const uint8_t** k,
                                     const uint8_t** v) const {
    const int p = key(it, j);
    if (p < lo || p > pos) return false;
    const int pg = page_shift >= 0 ? p >> page_shift : p / page_size;
    const KV* kr = cache + ((size_t)bt[pg] * 2 * kvh + h) * page_elems +
                   (size_t)((p - pg * page_size) * hd);
    *k = reinterpret_cast<const uint8_t*>(kr);
    *v = reinterpret_cast<const uint8_t*>(kr + kvh * page_elems);
    return true;
  }
  __device__ __forceinline__ bool full(int it) const {
    return key(it, 0) >= lo && key(it, KEYS - 1) <= pos;
  }
  __device__ __forceinline__ bool visible(int it, int j) const {
    const int p = key(it, j);
    return p >= lo && p <= pos;
  }
  __device__ __forceinline__ int rel_pos(int it, int j) const {
    return key(it, j) - pos;
  }
};

// Three blocks an SM: at most 170 registers a thread. Grid (request, KV
// head x row slice, split): slice z of a KV head's group takes its query
// rows [16 z, 16 z + 16), so a group past one mma tile (Falcon-7B's 71
// query heads on one KV head: 5 slices) runs as that many blocks, each
// reading the head's K/V tiles (the other slices' reads of them hit L2).
template <typename T, int HD, bool kCap, bool kAlibi, typename KV>
__global__ void __launch_bounds__(split::kThreads, 3)
dpa_split_tc_kernel(const T* __restrict__ q,
                    const KV* __restrict__ cache,
                    float* __restrict__ part_acc, float* __restrict__ part_m,
                    float* __restrict__ part_l,
                    const int* __restrict__ seq_lens,
                    const int* __restrict__ block_tables,
                    const float* __restrict__ alibi, int max_pages, int nq,
                    int kvh, int page_size, int hd, float scale,
                    int sliding_window, int chunk_attn, float soft_cap,
                    int tiles_per_split) {
  constexpr int KEYS = kTcKeys<HD>;
  const int r = blockIdx.x, split = blockIdx.z;
  const int splits = gridDim.z, group = nq / kvh;
  const int slices = gridDim.y / kvh;
  const int h = blockIdx.y / slices, slice = blockIdx.y - h * slices;
  const int g0 = slice * 16, rows = min(16, group - g0);
  DecodeKeys<KEYS, KV> keys;
  keys.cache = cache;
  keys.bt = block_tables + (size_t)r * max_pages;
  keys.pos = seq_lens[r] - 1;  // -1 for an empty row: no tile
  // The first visible key: both the window's and the chunk's bound hold,
  // so that [lo, pos] is exactly the visible range.
  keys.lo = 0;
  if (sliding_window > 0)
    keys.lo = max(keys.lo, keys.pos - sliding_window + 1);
  if (chunk_attn > 0 && keys.pos >= 0)
    keys.lo = max(keys.lo, keys.pos / chunk_attn * chunk_attn);
  const int t0 = keys.lo / KEYS;
  const int n = keys.pos >= 0 ? keys.pos / KEYS + 1 - t0 : 0;
  const int ta = split * tiles_per_split;
  keys.kv_base = (t0 + ta) * KEYS;
  keys.kvh = kvh;
  keys.h = h;
  keys.hd = hd;
  keys.page_size = page_size;
  keys.page_shift = __popc(page_size) == 1 ? __ffs(page_size) - 1 : -1;
  keys.page_elems = (size_t)page_size * hd;
  const int n_my = split::my_tiles(n, ta, tiles_per_split, split, splits);
  extern __shared__ uint4 smem_dpa[];
  split::tc_split<T, HD, KEYS, kCap, kAlibi, KV>(
      q, (size_t)r * nq + h * group + g0, rows, hd, n_my, scale, soft_cap,
      kAlibi ? alibi + h * group + g0 : nullptr, keys, part_acc, part_m,
      part_l, split, splits, smem_dpa);
}

// One block a query row (r * nq + query head): split::merge_row.
template <typename T>
__global__ void __launch_bounds__(128)
dpa_merge_kernel(const float* __restrict__ part_acc,
                 const float* __restrict__ part_m,
                 const float* __restrict__ part_l, T* __restrict__ out,
                 int hd, int splits) {
  split::merge_row<T, false>(blockIdx.x, part_acc, part_m, part_l, out,
                             nullptr, nullptr, nullptr, hd, splits);
}

struct TcArgs {
  const void *q, *cache;
  void* out;
  float *part_acc, *part_m, *part_l;
  const int *seq_lens, *block_tables;
  const float* alibi;
  int num_reqs, max_pages, nq, kvh, page_size, hd;
  float scale;
  int sliding_window, chunk_attn;
  float soft_cap;
  int splits, tiles_per_split;
  cudaStream_t stream;
};

template <typename T, int HD, bool kCap, bool kAlibi, typename KV>
int split_tc(const TcArgs& a) {
  constexpr int kSmem = split::TcCfg<HD, kTcKeys<HD>, KV>::kSmem;
  cudaError_t err =
      mma::allow_smem<dpa_split_tc_kernel<T, HD, kCap, kAlibi, KV>>(kSmem);
  if (err != cudaSuccess) return (int)err;
  const int slices = (a.nq / a.kvh + 15) / 16;
  dpa_split_tc_kernel<T, HD, kCap, kAlibi, KV>
      <<<dim3(a.num_reqs, a.kvh * slices, a.splits), split::kThreads, kSmem,
         a.stream>>>(static_cast<const T*>(a.q),
                     static_cast<const KV*>(a.cache), a.part_acc,
                     a.part_m, a.part_l, a.seq_lens, a.block_tables, a.alibi,
                     a.max_pages, a.nq, a.kvh, a.page_size, a.hd, a.scale,
                     a.sliding_window, a.chunk_attn, a.soft_cap,
                     a.tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dpa_merge_kernel<T><<<a.num_reqs * a.nq, 128, 0, a.stream>>>(
      a.part_acc, a.part_m, a.part_l, static_cast<T*>(a.out), a.hd,
      a.splits);
  return (int)cudaGetLastError();
}

template <typename T, int HD, typename KV>
int split_tc(const TcArgs& a) {
  const bool cap = a.soft_cap > 0.f, alibi = a.alibi != nullptr;
  if (cap && alibi) return split_tc<T, HD, true, true, KV>(a);
  if (cap) return split_tc<T, HD, true, false, KV>(a);
  if (alibi) return split_tc<T, HD, false, true, KV>(a);
  return split_tc<T, HD, false, false, KV>(a);
}

// The tiles' width: the narrowest of 64, 128 and 256 that holds hd (a
// multiple of 16).
template <typename T, typename KV>
int split_tc_hd(const TcArgs& a) {
  if (a.hd < 16 || a.hd % 16) return (int)cudaErrorInvalidValue;
  if (a.hd <= 64) return split_tc<T, 64, KV>(a);
  if (a.hd <= 128) return split_tc<T, 128, KV>(a);
  if (a.hd <= 256) return split_tc<T, 256, KV>(a);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core split and its merge for queries of T, on a cache in T
// or fp8 (a KvDtype code).
template <typename T>
int split_tc_kv(int kv_dtype, const TcArgs& a) {
  if (kv_dtype == kKvAuto) return split_tc_hd<T, T>(a);
  if (kv_dtype == kKvE4M3) return split_tc_hd<T, __nv_fp8_e4m3>(a);
  if (kv_dtype == kKvE5M2) return split_tc_hd<T, __nv_fp8_e5m2>(a);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename KV>
int launch(const void* q, const void* cache, void* out, const int* seq_lens,
           const int* block_tables, const float* alibi, int num_reqs,
           int max_pages, int nq, int kvh, int page_size, int hd, float scale,
           int sliding_window, int chunk_attn, float soft_cap, int warps,
           int smem_bytes, cudaStream_t stream) {
  // smem_bytes (computed by the wrapper): q [group, hd] fp32, then
  // `warps` WarpSmem regions.
  if (warps < 1 || warps > kMaxWarps || (hd * (int)sizeof(KV)) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = mma::allow_smem<dpa_kernel<T, KV>>(smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dpa_kernel<T, KV><<<dim3(num_reqs, kvh), warps * 32, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(cache),
      static_cast<T*>(out), seq_lens, block_tables, alibi, max_pages, nq, kvh,
      page_size, hd, scale, sliding_window, chunk_attn, soft_cap);
  return (int)cudaGetLastError();
}

// dpa_kernel on a cache in q's dtype or fp8 (a KvDtype code).
template <typename T>
int launch_kv(int kv_dtype, const void* q, const void* cache, void* out,
              const int* seq_lens, const int* block_tables,
              const float* alibi, int num_reqs, int max_pages, int nq,
              int kvh, int page_size, int hd, float scale, int sliding_window,
              int chunk_attn, float soft_cap, int warps, int smem_bytes,
              cudaStream_t s) {
#define DPA_KV(KV)                                                        \
  return launch<T, KV>(q, cache, out, seq_lens, block_tables, alibi,      \
                       num_reqs, max_pages, nq, kvh, page_size, hd, scale, \
                       sliding_window, chunk_attn, soft_cap, warps,       \
                       smem_bytes, s)
  if (kv_dtype == kKvAuto) DPA_KV(T);
  if (kv_dtype == kKvE4M3) DPA_KV(__nv_fp8_e4m3);
  if (kv_dtype == kKvE5M2) DPA_KV(__nv_fp8_e5m2);
#undef DPA_KV
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One call, on `stream`. tensor_cores: the bf16 or fp16 split instance (dtype 1
// or 2; head_dim a multiple of 16 up to 256, any group, cut into slices of
// 16 query rows): the split kernel over
// `splits` splits of `tiles_per_split` tiles, then the merge; part_acc [R, nq,
// splits, hd], part_m and part_l [R, nq, splits] fp32 scratch. Else dpa_kernel
// with `warps` warps and `smem_bytes` of shared memory (computed by the
// wrapper: q [group, hd] fp32, then `warps` WarpSmem regions); the split
// arguments are then unused. alibi: [nq] fp32 slopes or null. kv_dtype: the
// cache's KvDtype code (its dtype is q's, or fp8).
extern "C" int dpa_launch(int dtype, int kv_dtype, int tensor_cores,
                          const void* q,
                          const void* cache_layer, void* out,
                          float* part_acc, float* part_m, float* part_l,
                          const int* seq_lens, const int* block_tables,
                          const float* alibi, int num_reqs, int max_pages,
                          int nq, int kvh, int page_size, int hd,
                          float scale, int sliding_window, int chunk_attn,
                          float soft_cap, int splits, int tiles_per_split,
                          int warps, int smem_bytes, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (kvh <= 0 || nq % kvh) return (int)cudaErrorInvalidValue;
  if (tensor_cores) {
    if (splits < 1 || tiles_per_split < 1) return (int)cudaErrorInvalidValue;
    const TcArgs a{q, cache_layer, out, part_acc, part_m, part_l, seq_lens,
                   block_tables, alibi, num_reqs, max_pages, nq, kvh,
                   page_size, hd, scale, sliding_window, chunk_attn,
                   soft_cap, splits, tiles_per_split, s};
    if (dtype == kBFloat16) return split_tc_kv<__nv_bfloat16>(kv_dtype, a);
    if (dtype == kFloat16) return split_tc_kv<__half>(kv_dtype, a);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == kFloat32)
    return launch_kv<float>(kv_dtype, q, cache_layer, out, seq_lens,
                            block_tables, alibi, num_reqs, max_pages, nq,
                            kvh, page_size, hd, scale, sliding_window,
                            chunk_attn, soft_cap, warps, smem_bytes, s);
  if (dtype == kBFloat16)
    return launch_kv<__nv_bfloat16>(kv_dtype, q, cache_layer, out, seq_lens,
                                    block_tables, alibi, num_reqs, max_pages,
                                    nq, kvh, page_size, hd, scale,
                                    sliding_window, chunk_attn, soft_cap,
                                    warps, smem_bytes, s);
  if (dtype == kFloat16)
    return launch_kv<__half>(kv_dtype, q, cache_layer, out, seq_lens,
                             block_tables, alibi, num_reqs, max_pages, nq,
                             kvh, page_size, hd, scale, sliding_window,
                             chunk_attn, soft_cap, warps, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
