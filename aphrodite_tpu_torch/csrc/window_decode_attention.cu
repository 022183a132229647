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
// An fp8 cache (template type KV, e4m3fn or e5m2): the TPU kernel upcasts
// each K/V tile to q's dtype before both products (:162-164). The tails
// are in the cache's dtype, or bf16 beside an e5m2 cache (the reference
// runner's rule, aphrodite_tpu/worker/runner.py:519-520: attn::tail_t), and
// each tile is read in its own dtype: the tensor-core split stages an fp8
// tile's bytes and converts them in shared memory (split_decode.cuh), the
// CUDA-core split converts to fp32 as it stages.
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
// wd_split_tc_kernel (bf16 and fp16 at head_dim 64, 128 or 256, groups
// <= 16): split::tc_split (csrc/split_decode.cuh, shared with the decode
// kernel) with 64-key tiles at every head dim, q's dtype a template
// parameter (fp16's products f32.f16.f16.f32), the soft cap a template
// switch;
// this file gives it the window's keys (WindowKeys: page tiles from the
// first visible one, then tail tiles; under fp16 queries its bf16 tails
// beside an e5m2 cache are converted to fp16 in shared memory,
// split_decode.cuh). The padding of the group's rows to
// 16 is wasted work the bytes bound does not see.
//
// wd_split_kernel (fp32; bf16 and fp16 at other head dims or larger
// groups): the
// same tiles and states on the CUDA cores in full fp32 (no TF32), with the
// first version's per-warp staging: sub-tiles of up to 32 keys within a
// page, lane j owning key j, warps taking sub-tiles in turn. A group too
// large for one block's shared memory (MLA: 128 query heads at head_dim
// 576) is cut into slices of block_rows query heads, one block each.
//
// The bf16 MLA geometry (head_dim 576, any group) runs its own tensor-core
// instance, csrc/mla_attention.cu.
//
// What holds it back (PERF.md): its device time is 1.4-2.6x the bytes
// bound at the main paths, and a call's host time (the Python wrapper,
// ~65 us) exceeds it. At head_dim 256 the 143 KB ring leaves one block an
// SM (the decode kernel's 32-key tiles there leave three). Left for
// later: TMA loads with a producer warp, the decode kernel's smaller ring
// at head_dim 256, and folding the merge into the last split of each
// (request, head) when there is one split.
#include "split_decode.cuh"

namespace {

constexpr int kKeys = 64;  // keys a tile: the host plan's unit
using split::kWarps;
using split::my_tiles;
using split::write_state;

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

// ------------------------------------------ tensor-core split (bf16, fp16)
// The window's keys for split::tc_split under queries of T: tile it of the
// split that starts at tile ta is a page tile (positions from (t0 + t) *
// 64) or a tail tile (slots from (t - n_paged) * 64). Every tile takes the
// mask.
template <typename T, int HD, typename KV>
struct WindowKeys {
  using TT = attn::tail_t<KV>;
  const KV* cache;
  const TT *tail_k, *tail_v;
  const int* bt;
  Tiles tl;
  int ta, plen, step, q_pos, kvh, h, page_size, page_shift, sliding_window,
      chunk_attn;
  size_t page_elems, tail_base;

  __device__ __forceinline__ bool paged(int t) const { return t < tl.n_paged; }
  __device__ __forceinline__ int kv0(int t) const {
    return paged(t) ? (tl.t0 + t) * kKeys : (t - tl.n_paged) * kKeys;
  }
  __device__ __forceinline__ bool fp8(int it) const {
    return paged(ta + it) ? attn::is_fp8<KV> : attn::is_fp8<TT>;
  }
  // A bf16 tail tile under fp16 queries (beside an e5m2 cache).
  __device__ __forceinline__ bool recast(int it) const {
    return std::is_same<T, __half>::value &&
           std::is_same<TT, __nv_bfloat16>::value && !paged(ta + it);
  }
  __device__ __forceinline__ bool kv(int it, int j, const uint8_t** k,
                                     const uint8_t** v) const {
    const int t = ta + it, key = kv0(t) + j;  // page position or tail slot
    if (paged(t)) {
      if (key < tl.lo || key >= plen) return false;
      const int pg = page_shift >= 0 ? key >> page_shift : key / page_size;
      const KV* kr = cache + ((size_t)bt[pg] * 2 * kvh + h) * page_elems +
                     (size_t)(key - pg * page_size) * HD;
      *k = reinterpret_cast<const uint8_t*>(kr);
      *v = reinterpret_cast<const uint8_t*>(kr + kvh * page_elems);
      return true;
    }
    if (key > step) return false;
    *k = reinterpret_cast<const uint8_t*>(tail_k + tail_base +
                                          (size_t)key * HD);
    *v = reinterpret_cast<const uint8_t*>(tail_v + tail_base +
                                          (size_t)key * HD);
    return true;
  }
  __device__ __forceinline__ bool full(int) const { return false; }
  __device__ __forceinline__ bool visible(int it, int j) const {
    const int t = ta + it, key = kv0(t) + j;
    return paged(t) ? key >= tl.lo && key < plen &&
                          attn::local_ok(key, q_pos, sliding_window,
                                         chunk_attn)
                    : key <= step && attn::local_ok(plen + key, q_pos,
                                                    sliding_window,
                                                    chunk_attn);
  }
};

template <typename T, int HD, bool kCap, typename KV>
__global__ void __launch_bounds__(kWarps * 32)
wd_split_tc_kernel(const T* __restrict__ q,
                   const KV* __restrict__ cache,
                   const attn::tail_t<KV>* __restrict__ tail_k,
                   const attn::tail_t<KV>* __restrict__ tail_v,
                   float* __restrict__ part_acc, float* __restrict__ part_m,
                   float* __restrict__ part_l,
                   const int* __restrict__ paged_lens,
                   const int* __restrict__ block_tables, int max_pages,
                   int nq, int kvh, int page_size, int kw, int step,
                   float scale, int sliding_window, int chunk_attn,
                   float soft_cap, int shared_len, int tiles_per_split) {
  const int r = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z, group = nq / kvh;
  WindowKeys<T, HD, KV> keys;
  keys.cache = cache;
  keys.tail_k = tail_k;
  keys.tail_v = tail_v;
  keys.bt = block_tables + (size_t)r * max_pages;
  keys.plen = paged_lens[r];
  keys.step = step;
  keys.q_pos = keys.plen + step;
  keys.tl = request_tiles(keys.plen, step, sliding_window, chunk_attn,
                          shared_len);
  keys.ta = split * tiles_per_split;
  keys.kvh = kvh;
  keys.h = h;
  keys.page_size = page_size;
  keys.page_shift = __popc(page_size) == 1 ? __ffs(page_size) - 1 : -1;
  keys.sliding_window = sliding_window;
  keys.chunk_attn = chunk_attn;
  keys.page_elems = (size_t)page_size * HD;
  keys.tail_base = ((size_t)r * kvh + h) * kw * HD;
  const int n_my =
      my_tiles(keys.tl.n, keys.ta, tiles_per_split, split, splits);
  extern __shared__ uint4 smem_wd[];
  split::tc_split<T, HD, kKeys, kCap, false, KV>(
      q, (size_t)r * nq + h * group, group, HD, n_my, scale, soft_cap, nullptr,
      keys, part_acc, part_m, part_l, split, splits, smem_wd);
}

// ------------------------------------------------------ CUDA-core split
template <typename T, typename KV>
__global__ void __launch_bounds__(kWarps * 32)
wd_split_kernel(const T* __restrict__ q, const KV* __restrict__ cache,
                const attn::tail_t<KV>* __restrict__ tail_k,
                const attn::tail_t<KV>* __restrict__ tail_v,
                float* __restrict__ part_acc, float* __restrict__ part_m,
                float* __restrict__ part_l,
                const int* __restrict__ paged_lens,
                const int* __restrict__ block_tables, int max_pages, int nq,
                int kvh, int page_size, int hd, int kw, int step,
                float scale, int sliding_window, int chunk_attn,
                float soft_cap, int shared_len, int tiles_per_split,
                int block_rows) {
  using namespace attn;
  const int r = blockIdx.x, split = blockIdx.z;
  const int splits = gridDim.z, group = nq / kvh;
  // grid.y: (KV head, slice of block_rows query heads of its group).
  const int slices = (group + block_rows - 1) / block_rows;
  const int h = blockIdx.y / slices;
  const int g0 = (blockIdx.y - h * slices) * block_rows;
  const int gb = min(block_rows, group - g0);  // this block's query rows
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
  const size_t row0 = (size_t)r * nq + h * group + g0;

  extern __shared__ float smem[];
  float* q_s = smem;                                    // [block_rows, hd]
  const size_t per_warp = (size_t)kTile * (hd + 1) + kTile * hd + kTile +
                          (size_t)block_rows * hd + 2 * block_rows;
  float* w_s = q_s + (size_t)block_rows * hd + warp * per_warp;
  float* k_s = w_s;                                     // [kTile, hd + 1]
  float* v_s = k_s + kTile * (hd + 1);                  // [kTile, hd]
  float* p_w = v_s + kTile * hd;                        // [kTile]
  float* acc_w = p_w + kTile;                           // [block_rows, hd]
  float* m_w = acc_w + (size_t)block_rows * hd;         // [block_rows]
  float* l_w = m_w + block_rows;                        // [block_rows]

  for (int i = threadIdx.x; i < gb * hd; i += blockDim.x)
    q_s[i] = to_float(q[row0 * hd + i]);
  for (int i = lane; i < gb * hd; i += 32) acc_w[i] = 0.f;
  for (int g = lane; g < gb; g += 32) {
    m_w[g] = -INFINITY;
    l_w[g] = 0.f;
  }
  __syncthreads();

  const size_t page_elems = (size_t)page_size * hd;
  const size_t tail_base = ((size_t)r * kvh + h) * kw * hd;
  for (int u = warp; u < n_my * per_tile; u += n_warps) {
    const int t = ta + u / per_tile, k0 = (u % per_tile) * sub;
    int n, kv0;
    bool paged = t < tl.n_paged;
    if (paged) {
      kv0 = (tl.t0 + t) * kKeys + k0;
      n = min(sub, plen - kv0);
      if (n <= 0 || kv0 + sub <= tl.lo) continue;  // nothing visible
      const int page_id = block_tables[(size_t)r * max_pages + kv0 / page_size];
      const size_t base = ((size_t)page_id * 2 * kvh + h) * page_elems +
                          (size_t)(kv0 % page_size) * hd;
      __syncwarp();  // this warp's previous sub-tile fully consumed
      load_tile(cache + base, cache + base + kvh * page_elems, n, hd, k_s,
                v_s, lane, 32);  // in the cache's dtype
    } else {
      const int j0 = (t - tl.n_paged) * kKeys + k0;
      n = min(sub, step + 1 - j0);
      if (n <= 0) continue;
      kv0 = plen + j0;
      __syncwarp();
      load_tile(tail_k + tail_base + (size_t)j0 * hd,
                tail_v + tail_base + (size_t)j0 * hd, n, hd, k_s, v_s, lane,
                32);  // in the tails' dtype
    }
    __syncwarp();
    const int kv_pos = kv0 + lane;
    const bool valid = lane < n && (!paged || kv_pos >= tl.lo) &&
                       local_ok(kv_pos, q_pos, sliding_window, chunk_attn);
    for (int g = 0; g < gb; ++g)
      tile_update(q_s + (size_t)g * hd, k_s, v_s, n, hd, valid, scale,
                  soft_cap, acc_w + (size_t)g * hd, m_w + g, l_w + g, p_w,
                  lane);
  }
  __syncthreads();

  // Merge the warps' states into the block's.
  for (int i = threadIdx.x; i < gb * hd; i += blockDim.x) {
    const int g = i / hd, d = i - g * hd;
    float m = -INFINITY;
    for (int w = 0; w < n_warps; ++w)
      m = fmaxf(m, q_s[(size_t)block_rows * hd + w * per_warp +
                       kTile * (2 * hd + 2) + (size_t)block_rows * hd + g]);
    float acc = 0.f, l = 0.f;
    if (m != -INFINITY) {
      for (int w = 0; w < n_warps; ++w) {
        const float* ws = q_s + (size_t)block_rows * hd + w * per_warp;
        const float* aw = ws + kTile * (2 * hd + 2);
        const float mw = aw[(size_t)block_rows * hd + g];
        if (mw == -INFINITY) continue;
        const float c = expf(mw - m);
        acc += aw[i] * c;
        l += aw[(size_t)block_rows * hd + block_rows + g] * c;
      }
    }
    write_state(part_acc, part_m, part_l, row0 + g, split, splits, hd, d,
                acc, m, l);
  }
}

// ---------------------------------------------------------------- merge
// One block a query row (r * nq + query head): split::merge_row.
template <typename T, bool kCascade>
__global__ void __launch_bounds__(128)
wd_merge_kernel(const float* __restrict__ part_acc,
                const float* __restrict__ part_m,
                const float* __restrict__ part_l, T* __restrict__ out,
                const float* __restrict__ acc0, const float* __restrict__ m0,
                const float* __restrict__ l0, int hd, int splits) {
  split::merge_row<T, kCascade>(blockIdx.x, part_acc, part_m, part_l, out,
                                acc0, m0, l0, hd, splits);
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
  int shared_len, splits, tiles_per_split, warps, smem_bytes, block_rows;
  cudaStream_t stream;
};

template <typename T, int HD, bool kCap, typename KV>
int split_tc(const Args& a) {
  constexpr int kSmem = split::TcCfg<HD, kKeys, KV>::kSmem;
  const cudaError_t err =
      mma::allow_smem<wd_split_tc_kernel<T, HD, kCap, KV>>(kSmem);
  if (err != cudaSuccess) return (int)err;
  using TT = attn::tail_t<KV>;
  wd_split_tc_kernel<T, HD, kCap, KV>
      <<<dim3(a.num_reqs, a.kvh, a.splits), kWarps * 32, kSmem, a.stream>>>(
          static_cast<const T*>(a.q),
          static_cast<const KV*>(a.cache), static_cast<const TT*>(a.tail_k),
          static_cast<const TT*>(a.tail_v), a.part_acc, a.part_m,
          a.part_l, a.paged_lens, a.block_tables, a.max_pages, a.nq, a.kvh,
          a.page_size, a.kw, a.step, a.scale, a.sliding_window, a.chunk_attn,
          a.soft_cap, a.shared_len, a.tiles_per_split);
  return (int)cudaGetLastError();
}

template <typename T, int HD, typename KV>
int split_tc(const Args& a) {
  return a.soft_cap > 0.f ? split_tc<T, HD, true, KV>(a)
                          : split_tc<T, HD, false, KV>(a);
}

template <typename T, typename KV>
int split_tc_hd(const Args& a) {
  if (a.hd == 64) return split_tc<T, 64, KV>(a);
  if (a.hd == 128) return split_tc<T, 128, KV>(a);
  if (a.hd == 256) return split_tc<T, 256, KV>(a);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename KV>
int split_cuda_cores(const Args& a) {
  const cudaError_t err =
      mma::allow_smem<wd_split_kernel<T, KV>>(a.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  using TT = attn::tail_t<KV>;
  const int slices = (a.nq / a.kvh + a.block_rows - 1) / a.block_rows;
  wd_split_kernel<T, KV><<<dim3(a.num_reqs, a.kvh * slices, a.splits),
                           a.warps * 32, a.smem_bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.cache),
      static_cast<const TT*>(a.tail_k), static_cast<const TT*>(a.tail_v),
      a.part_acc, a.part_m, a.part_l, a.paged_lens, a.block_tables,
      a.max_pages, a.nq, a.kvh, a.page_size, a.hd, a.kw, a.step, a.scale,
      a.sliding_window, a.chunk_attn, a.soft_cap, a.shared_len,
      a.tiles_per_split, a.block_rows);
  return (int)cudaGetLastError();
}

// The CUDA-core split on a cache in q's dtype or fp8 (a KvDtype code).
template <typename T>
int split_cuda_cores_kv(int kv_dtype, const Args& a) {
  if (kv_dtype == kKvAuto) return split_cuda_cores<T, T>(a);
  if (kv_dtype == kKvE4M3) return split_cuda_cores<T, __nv_fp8_e4m3>(a);
  if (kv_dtype == kKvE5M2) return split_cuda_cores<T, __nv_fp8_e5m2>(a);
  return (int)cudaErrorInvalidValue;
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

// The tensor-core split on a cache in q's dtype T or fp8 (a KvDtype code),
// then the merge.
template <typename T>
int tensor_cores_kv(int kv_dtype, const Args& a) {
  int err = (int)cudaErrorInvalidValue;
  if (kv_dtype == kKvAuto) err = split_tc_hd<T, T>(a);
  else if (kv_dtype == kKvE4M3) err = split_tc_hd<T, __nv_fp8_e4m3>(a);
  else if (kv_dtype == kKvE5M2) err = split_tc_hd<T, __nv_fp8_e5m2>(a);
  return err != 0 ? err : merge<T>(a);
}

}  // namespace

// One call launches the split kernel, then the merge, on `stream`.
// tensor_cores: the bf16 or fp16 instance (dtype 1 or 2; head_dim 64, 128
// or 256, nq / kvh <= 16); else the CUDA-core one (fp32, bf16 or fp16)
// with `warps` warps and `smem_bytes` of shared memory, each block taking
// `block_rows` query heads of a KV head's group (ops/
// window_decode_attention.py: window_warps, window_block_rows; the bf16
// MLA geometry runs csrc/mla_attention.cu). kv_dtype: the
// cache's KvDtype code; the tails are in attn::tail_t of the cache's type.
// part_acc [R, nq, splits, hd], part_m and part_l [R, nq, splits] fp32 scratch.
// acc0 [R, nq, hd], m0 and l0 [R, nq] (fp32): the cascade's init state
// covering page positions < shared_len, or all three null (shared_len 0).
extern "C" int wd_launch(int dtype, int kv_dtype, int tensor_cores,
                         const void* q,
                         const void* cache_layer, const void* tail_k_layer,
                         const void* tail_v_layer, void* out, float* part_acc,
                         float* part_m, float* part_l, const int* paged_lens,
                         const int* block_tables, int num_reqs, int max_pages,
                         int nq, int kvh, int page_size, int hd, int kw,
                         int step, float scale, int sliding_window,
                         int chunk_attn, float soft_cap, const float* acc0,
                         const float* m0, const float* l0, int shared_len,
                         int splits, int tiles_per_split, int warps,
                         int smem_bytes, int block_rows, void* stream) {
  if ((acc0 == nullptr) != (m0 == nullptr) ||
      (acc0 == nullptr) != (l0 == nullptr) || shared_len < 0 ||
      (acc0 == nullptr && shared_len != 0) || kvh <= 0 || nq % kvh ||
      splits < 1 || tiles_per_split < 1 || block_rows < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, cache_layer, tail_k_layer, tail_v_layer, out, part_acc,
               part_m, part_l, paged_lens, block_tables, num_reqs, max_pages,
               nq, kvh, page_size, hd, kw, step, scale, sliding_window,
               chunk_attn, soft_cap, acc0, m0, l0, shared_len, splits,
               tiles_per_split, warps, smem_bytes, block_rows,
               static_cast<cudaStream_t>(stream)};
  int err = (int)cudaErrorInvalidValue;
  if (tensor_cores) {
    if (nq / kvh > 16) return err;
    if (dtype == kBFloat16) return tensor_cores_kv<__nv_bfloat16>(kv_dtype, a);
    if (dtype == kFloat16) return tensor_cores_kv<__half>(kv_dtype, a);
    return err;
  }
  if (warps < 1 || warps > kWarps) return err;
  if (dtype == kFloat32) {
    err = split_cuda_cores_kv<float>(kv_dtype, a);
    return err != 0 ? err : merge<float>(a);
  }
  if (dtype == kBFloat16) {
    err = split_cuda_cores_kv<__nv_bfloat16>(kv_dtype, a);
    return err != 0 ? err : merge<__nv_bfloat16>(a);
  }
  if (dtype == kFloat16) {
    err = split_cuda_cores_kv<__half>(kv_dtype, a);
    return err != 0 ? err : merge<__half>(a);
  }
  return err;
}
