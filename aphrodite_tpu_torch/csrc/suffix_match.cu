// Suffix match lengths (CUDA, sm_90a) for DRY and no-repeat-ngram.
//
// For each row r of int32 histories seq [R, L] with end = total_len[r] - 1
// and every position j, the longest u <= max_match with
//
//     seq[j - i] == seq[end - i]   for i = 1..u   (j - i >= 0, end - i >= 0)
//
// as m_plain[r, j]; m_break[r, j] also stops at the first j - i that
// break_mask marks (DRY's sequence breakers). Both int32 [R, L].
//
// Replaces `_suffix_match_lengths` of aphrodite_tpu/sample/sampler.py:38-67,
// a fori_loop of 64 steps over [R, L] that XLA fuses into one loop and that
// eager PyTorch would run as some 640 launches. Integers only, so the kernel
// equals the plain version (ops/suffix_match.py) bit for bit.
//
// Design. One block of kThreads threads covers kThreads positions of one
// row; thread j owns position j. The row's tail seq[end - i], i = 1..64,
// is the same for every position and sits in shared memory, as does the
// block's slice of the history with the 64 positions before it, so the
// loop reads shared memory only. A thread stops at its first mismatch:
// alive_b implies alive_p, so once alive_p is false neither count grows.
//
// Bound. 13 bytes a position (seq and break_mask read, two int32 counts
// written): at R = 32, L = 2048 some 0.85 MB, a quarter of a microsecond at
// 3.35 TB/s. The comparisons depend on the data (a random history stops
// at u = 1 almost everywhere). Either way the launch itself dominates.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMatch = 64;

__global__ void __launch_bounds__(kThreads)
suffix_match_kernel(const int* __restrict__ seq,
                    const int* __restrict__ total_len,
                    const uint8_t* __restrict__ break_mask,
                    int* __restrict__ m_plain, int* __restrict__ m_break,
                    int L, int max_match) {
  __shared__ int tail[kMaxMatch + 1];
  __shared__ int hist[kMaxMatch + kThreads];
  __shared__ uint8_t brk[kMaxMatch + kThreads];
  const int r = blockIdx.y;
  const int j0 = blockIdx.x * kThreads;
  const int end = total_len[r] - 1;
  const int* row = seq + (size_t)r * L;
  const uint8_t* brow = break_mask + (size_t)r * L;
  for (int i = threadIdx.x; i <= kMaxMatch; i += kThreads) {
    tail[i] = (i >= 1 && end - i >= 0) ? row[end - i] : 0;
  }
  // hist[k] = seq[j0 - kMaxMatch + k]; out-of-range slots are never read
  // as a match (the j - u >= 0 test comes first).
  for (int k = threadIdx.x; k < kMaxMatch + kThreads; k += kThreads) {
    const int p = j0 - kMaxMatch + k;
    const bool in = p >= 0 && p < L;
    hist[k] = in ? row[p] : 0;
    brk[k] = in ? brow[p] : 0;
  }
  __syncthreads();
  const int j = j0 + threadIdx.x;
  if (j >= L) return;
  bool alive_p = true, alive_b = true;
  int mp = 0, mb = 0;
  for (int u = 1; u <= max_match && alive_p; ++u) {
    const int k = threadIdx.x + kMaxMatch - u;  // slot of position j - u
    const bool ok = j - u >= 0 && end - u >= 0 && hist[k] == tail[u];
    alive_p = alive_p && ok;
    alive_b = alive_b && ok && !brk[k];
    mp += alive_p;
    mb += alive_b;
  }
  m_plain[(size_t)r * L + j] = mp;
  m_break[(size_t)r * L + j] = mb;
}

}  // namespace

extern "C" int suffix_match_launch(const void* seq, const void* total_len,
                                   const void* break_mask, void* m_plain,
                                   void* m_break, int R, int L, int max_match,
                                   void* stream) {
  if (R <= 0 || L <= 0) return (int)cudaSuccess;
  if (max_match < 0 || max_match > kMaxMatch || R > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((L + kThreads - 1) / kThreads, R);
  suffix_match_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seq), static_cast<const int*>(total_len),
      static_cast<const uint8_t*>(break_mask), static_cast<int*>(m_plain),
      static_cast<int*>(m_break), L, max_match);
  return (int)cudaGetLastError();
}
