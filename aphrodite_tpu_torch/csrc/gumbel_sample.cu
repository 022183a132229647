// Seeded Gumbel-max sampling (CUDA, sm_90a): for each row r of fp32
// logprobs lp [R, V]
//
//     token[r] = argmax_v  isfinite(lp[r, v]) ? lp[r, v] + g_r[v] : -inf
//
// with g_r = jax.random.gumbel(key_r, (V,)) and key_r the JAX sampler's
// per-row sample key: fold_in(fold_in(PRNGKey(seed[r]), out_len[r] +
// step_offset), 2). Ties go to the first index, as jnp.argmax; a row that
// is all -inf gives 0.
//
// Replaces the Gumbel-max draw of sample_tokens, aphrodite_tpu/sample/
// sampler.py:494-504, which XLA fuses; in eager PyTorch the threefry
// rounds alone are some 120 launches over [R, V] a call.
//
// The noise. threefry2x32 (20 rounds, key injection after every 4) in
// uint32 registers, the rotate a funnel shift. jax_threefry_partitionable
// layout: column v's bits are x0 ^ x1 of threefry(key, (0, v)). The
// uniform puts the top 23 bits under 1.0's exponent and subtracts 1, then
// scales to [tiny, 1): in fp32 maxval - minval rounds to 1, so that is
// max(tiny, f + tiny). g = -logf(-logf(u)) (logf, not __logf: within an
// ulp of the host's log). No [R, V] noise tensor is ever written.
//
// Design. Blocks of kThreads threads split a row into slices of
// kThreads * kPerThread columns, neighbouring threads on neighbouring
// columns. Each column's score becomes an order-preserving 64-bit key
// (the score's bits, flipped to sort as unsigned, above 0xFFFFFFFF - v, so
// a larger key is a larger score or, at a tie, a smaller index); a thread,
// a warp and the block keep the largest, and the block writes it to a
// [R, B] partial. A second kernel takes each row's largest partial.
//
// Bound. Integer operations, not bytes: per column one add and the 20
// rounds' add, funnel shift and xor, 5 key injections of 2 adds, then xor,
// shift and or for the float: 74 int32 operations (INT_OPS_PER_COLUMN of
// ops/gumbel_sample.py, which chip_smoke.py counts against the card's
// INT32 rate); 4 bytes read. At
// R = 32, V = 128256 that is 304 M operations against 16.4 MB.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kSlice = kThreads * kPerThread;
constexpr float kTiny = 1.17549435e-38f;  // float32's smallest normal
#define kNegInf __int_as_float(0xff800000)

struct Pair {
  uint32_t x0, x1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

__device__ __forceinline__ Pair threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return {x0, x1};
}

// The row's sample key: fold_in(fold_in(PRNGKey(seed), counter), 2).
__device__ __forceinline__ Pair sample_key(uint32_t seed, uint32_t counter) {
  const Pair k = threefry2x32(0u, seed, 0u, counter);
  return threefry2x32(k.x0, k.x1, 0u, 2u);
}

__device__ __forceinline__ uint32_t column_bits(Pair key, uint32_t v) {
  const Pair y = threefry2x32(key.x0, key.x1, 0u, v);
  return y.x0 ^ y.x1;
}

__device__ __forceinline__ float unit_uniform(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(__fadd_rn(f, kTiny), kTiny);
}

__device__ __forceinline__ float gumbel(float u) {
  return -logf(-logf(u));
}

__device__ __forceinline__ uint64_t order_key(float s, uint32_t v) {
  if (s == 0.f) s = 0.f;  // -0 and +0 tie, as they compare
  uint32_t b = __float_as_uint(s);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((uint64_t)b << 32) | (uint64_t)(0xFFFFFFFFu - v);
}

__device__ __forceinline__ uint64_t warp_max(uint64_t k) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t other = __shfl_xor_sync(0xFFFFFFFFu, k, o);
    k = other > k ? other : k;
  }
  return k;
}

__global__ void __launch_bounds__(kThreads)
gumbel_partial_kernel(const float* __restrict__ lp,
                      const long long* __restrict__ seeds,
                      const int* __restrict__ out_len, int step_offset,
                      int V, uint64_t* __restrict__ partial) {
  __shared__ Pair key_s;
  __shared__ uint64_t warp_best[kThreads / 32];
  const int r = blockIdx.y;
  if (threadIdx.x == 0) {
    key_s = sample_key((uint32_t)seeds[r],
                       (uint32_t)(out_len[r] + step_offset));
  }
  __syncthreads();
  const Pair key = key_s;
  const float* row = lp + (size_t)r * V;
  const int base = blockIdx.x * kSlice + threadIdx.x;
  uint64_t best = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int v = base + k * kThreads;
    if (v < V) {
      const float x = __ldg(row + v);
      const float g = gumbel(unit_uniform(column_bits(key, (uint32_t)v)));
      const float s = isfinite(x) ? __fadd_rn(x, g) : kNegInf;
      const uint64_t kv = order_key(s, (uint32_t)v);
      best = kv > best ? kv : best;
    }
  }
  best = warp_max(best);
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x < 32) {
    best = threadIdx.x < kThreads / 32 ? warp_best[threadIdx.x] : 0;
    best = warp_max(best);
    if (threadIdx.x == 0) partial[(size_t)r * gridDim.x + blockIdx.x] = best;
  }
}

__global__ void __launch_bounds__(32)
gumbel_final_kernel(const uint64_t* __restrict__ partial, int B,
                    long long* __restrict__ tokens) {
  const int r = blockIdx.x;
  uint64_t best = 0;
  for (int b = threadIdx.x; b < B; b += 32) {
    const uint64_t k = partial[(size_t)r * B + b];
    best = k > best ? k : best;
  }
  best = warp_max(best);
  if (threadIdx.x == 0)
    tokens[r] = (long long)(0xFFFFFFFFu - (uint32_t)(best & 0xFFFFFFFFu));
}

__global__ void __launch_bounds__(kThreads)
gumbel_noise_kernel(const long long* __restrict__ seeds,
                    const int* __restrict__ out_len, int step_offset, int V,
                    uint32_t* __restrict__ bits, float* __restrict__ unif,
                    float* __restrict__ noise) {
  const int r = blockIdx.y;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= V) return;
  const Pair key = sample_key((uint32_t)seeds[r],
                              (uint32_t)(out_len[r] + step_offset));
  const uint32_t b = column_bits(key, (uint32_t)v);
  const float u = unit_uniform(b);
  const size_t i = (size_t)r * V + v;
  bits[i] = b;
  unif[i] = u;
  noise[i] = gumbel(u);
}

}  // namespace

// Columns a block of the first kernel covers: the wrapper sizes the
// [R, B] partial buffer with it.
extern "C" int gumbel_sample_slice() { return kSlice; }

extern "C" int gumbel_sample_launch(const void* lp, const void* seeds,
                                    const void* out_len, int step_offset,
                                    int R, int V, void* partial,
                                    void* tokens, void* stream) {
  if (R <= 0 || V <= 0) return (int)cudaSuccess;
  if (R > 65535) return (int)cudaErrorInvalidValue;
  const int B = (V + kSlice - 1) / kSlice;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gumbel_partial_kernel<<<dim3(B, R), kThreads, 0, s>>>(
      static_cast<const float*>(lp), static_cast<const long long*>(seeds),
      static_cast<const int*>(out_len), step_offset, V,
      static_cast<uint64_t*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gumbel_final_kernel<<<R, 32, 0, s>>>(
      static_cast<const uint64_t*>(partial), B,
      static_cast<long long*>(tokens));
  return (int)cudaGetLastError();
}

// The noise alone, for checking it against jax.random's stream: the bits,
// the uniforms and the Gumbel values [R, V] of every row's sample key.
extern "C" int gumbel_noise_launch(const void* seeds, const void* out_len,
                                   int step_offset, int R, int V, void* bits,
                                   void* unif, void* noise, void* stream) {
  if (R <= 0 || V <= 0) return (int)cudaSuccess;
  if (R > 65535) return (int)cudaErrorInvalidValue;
  gumbel_noise_kernel<<<dim3((V + kThreads - 1) / kThreads, R), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(seeds), static_cast<const int*>(out_len),
      step_offset, V, static_cast<uint32_t*>(bits),
      static_cast<float*>(unif), static_cast<float*>(noise));
  return (int)cudaGetLastError();
}
