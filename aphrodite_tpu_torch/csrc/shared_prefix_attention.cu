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
// Design. A block of 8 warps runs one (tile of 32 query rows, KV head); a
// warp owns 4 rows and keeps their acc in registers (lane d holds dims d,
// d + 32, ...) with their m and l. The shared tokens are walked in tiles of
// min(page, 32) keys, staged once a block in shared memory as fp32: K
// transposed [hd][33], so that lane j (key j) reads its column without
// bank conflicts, and V [32][hd + 1]. The next tile's K and V are loaded
// into registers while the block computes on this one: thread i takes 16
// bytes of key i % 32, so that its stores into both tiles, one key a lane,
// hit 32 banks. Lane j
// takes the 4 rows' logits for key j (one K value feeds 4 FMAs, q is a
// broadcast float4), then lane d the 4 rows' PV for its dims (one V value
// feeds 4 FMAs).
//
// Bound. At the Llama-3.1-8B cascade path (R 128, 32 / 8 heads of 128, S =
// 1024, bf16) a launch reads 4 MB of K/V and 1 MB of q and writes 2 MB of
// state, ~2.2 us at 3.35 TB/s, and does 2.1 GFLOP, ~2.2 us on the bf16
// tensor cores. This version runs on the CUDA cores in fp32 (as the other
// attention kernels of the port); mma.sync for QK^T and PV is the next step.
#include "attn_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;                      // query rows a warp
constexpr int kBlockRows = kWarps * kRows;    // query rows a block
constexpr int kThreads = kWarps * 32;

template <typename T, int C>  // C = hd / 32
__global__ void __launch_bounds__(kThreads)
spa_kernel(const T* __restrict__ q, const T* __restrict__ cache,
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
  // A tile's K and V in 16-byte vectors of kVec values, kLoads a thread:
  // vector i is dims [kVec (i / 32), kVec (i / 32 + 1)) of key i % 32.
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLoads = kTile * hd / kVec / kThreads;
  static_assert(kLoads * kThreads * kVec == kTile * hd, "whole vectors");
  uint4 k_reg[kLoads], v_reg[kLoads];
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
      k_reg[u] = __ldg(reinterpret_cast<const uint4*>(cache + row + d0));
      v_reg[u] = __ldg(reinterpret_cast<const uint4*>(
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
        const T* kv = reinterpret_cast<const T*>(&k_reg[u]);
        const T* vv = reinterpret_cast<const T*>(&v_reg[u]);
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

template <typename T, int C>
int launch_c(const void* q, const void* cache, const int* shared_pages,
             int shared_len, float* acc, float* m, float* l, int num_reqs,
             int nq, int kvh, int page_size, float scale, int smem_bytes,
             cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      spa_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int rows = num_reqs * (nq / kvh);
  const dim3 grid((rows + kBlockRows - 1) / kBlockRows, kvh);
  spa_kernel<T, C><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cache), shared_pages,
      shared_len, acc, m, l, num_reqs, nq, kvh, page_size, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* cache, const int* shared_pages,
           int shared_len, float* acc, float* m, float* l, int num_reqs,
           int nq, int kvh, int page_size, int hd, float scale,
           int smem_bytes, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_c<T, 2>(q, cache, shared_pages, shared_len, acc, m, l,
                            num_reqs, nq, kvh, page_size, scale, smem_bytes,
                            stream);
    case 128:
      return launch_c<T, 4>(q, cache, shared_pages, shared_len, acc, m, l,
                            num_reqs, nq, kvh, page_size, scale, smem_bytes,
                            stream);
    case 256:
      return launch_c<T, 8>(q, cache, shared_pages, shared_len, acc, m, l,
                            num_reqs, nq, kvh, page_size, scale, smem_bytes,
                            stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [R, nq, hd] and the layer's cache [P, 2, kvh, page, hd] in one dtype
// (code 0 fp32, 1 bf16); shared_pages: the pages holding the prefix's
// shared_len tokens, in order. acc [R, nq, hd], m and l [R, nq] fp32.
// smem_bytes (computed by the wrapper): q rows [32][hd], K transposed
// [hd][33], V [32][hd + 1] and p [8 warps][4 rows][32], all fp32.
extern "C" int spa_launch(int dtype, const void* q, const void* cache_layer,
                          const int* shared_pages, int shared_len, float* acc,
                          float* m, float* l, int num_reqs, int nq, int kvh,
                          int page_size, int hd, float scale, int smem_bytes,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (num_reqs < 1 || kvh < 1 || nq % kvh != 0 || shared_len < 0 ||
      page_size < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch<float>(q, cache_layer, shared_pages, shared_len, acc, m, l,
                         num_reqs, nq, kvh, page_size, hd, scale, smem_bytes,
                         s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, cache_layer, shared_pages, shared_len,
                                 acc, m, l, num_reqs, nq, kvh, page_size, hd,
                                 scale, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
