// The token-history pass (CUDA, sm_90a): DRY, the presence / frequency /
// repetition penalties and no-repeat-ngram in one launch a draw.
//
// For each row r of fp32 logits [R, V], with the history seq[r, :T]
// (T = total_len[r], end = T - 1, P = prompt_len[r]), the kernel computes
// what these compute, in this order (aphrodite_tpu/sample/sampler.py):
//
//   _suffix_match_lengths (:38-67)   m_plain / m_break of every position
//   _apply_dry (:70-118)             logits -= mult * base ** (len - allowed)
//   _apply_penalties (:144-167)      repetition, frequency, presence
//   _apply_no_repeat_ngram (:121-141) logits = -inf at banned tokens
//
// each stage on where the launch's `stages` bits say (SamplerFlags) and
// each row self-masking on its own parameters. No Pallas kernel: XLA fuses
// the JAX stages; eager PyTorch ran them as some 60 launches a draw, four
// of them scatters into zeroed [R, V + 1] int32 buffers.
//
// Every stage changes logits only at tokens that occur in the row's
// history. So one block takes a row (a grid-stride loop over rows) and
// reads the history once:
//  1. warp 0 reads the tail seq[end - i], i = 0..64, into shared memory
//     and finds DRY's window (the first i with a breaker at end - i) by
//     ballot;
//  2. each thread takes positions j of the history: it counts seq[j]
//     toward the prompt (j < P) or the output (P <= j < T), and where
//     seq[j] is the last token it extends the two suffix matches only as
//     far as the row needs them (DRY's window - 1, the n-gram's n - 2;
//     at most 64), then adds DRY's new_len (an amax) and the n-gram's ban
//     at the next token seq[j + 1];
//  3. those go into a per-row hash table of the distinct tokens (linear
//     probing, the key token + 1, 0 empty): four int32 words a slot, the
//     key, DRY's length, the prompt count with the ban in its top bit
//     (an atomicOr beside atomicAdds of 1 that never reach it) and the
//     output count;
//  4. after one __syncthreads, one thread a slot reads logits[r, tok],
//     applies DRY -> penalties -> ban with the plain version's fp32
//     operations in its order, rounding each one as torch does (no FMA
//     contraction: __fmul_rn / __fsub_rn / __fdiv_rn; powf is the function
//     torch.pow calls on the card), and writes it back.
// Integer atomics only, so the result does not depend on the order the
// threads run in. Nothing of [R, V] is read or written but the touched
// logits. The table (and the history) live in shared memory where they fit
// (L <= 4096: 36 bytes a history slot); longer histories use a table in
// device memory, one slice a block, that every launch leaves zero.
//
// Bound. Bytes: the history read once (4 L a row) and 8 bytes a distinct
// token (its logit read and written). Operations: the integer compares of
// the matches the data needs. At phase 20's shape (R = 32, L = 1024, ~600
// tokens a row) either is well under a microsecond: the launch and the
// block's serial steps (the tail, two barriers, hash probes) dominate.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxMatch = 64;     // MAX_MATCH of the sampler
constexpr int kMaxBreakers = 16;  // MAX_BREAKERS of the metadata
constexpr int kDry = 1, kPenalties = 2, kNgram = 4;
constexpr int kBan = (int)0x80000000u;
constexpr int kCountMask = 0x7fffffff;

struct Params {
  float* logits;
  const int* seq;
  const int* prompt_len;
  const int* total_len;
  const int* breakers;
  const float* dry_mult;
  const float* dry_base;
  const int* dry_allowed;
  const int* dry_range;
  const int* ngram;
  const float* presence;
  const float* frequency;
  const float* repetition;
  int* table;  // device-memory tables (4 * cap ints a block), or null
  int V, L, R, cap, stages;
};

__device__ __forceinline__ bool is_breaker(const int* brk, int tok) {
  bool hit = false;
#pragma unroll
  for (int k = 0; k < kMaxBreakers; ++k) hit |= brk[k] == tok;
  return hit;
}

// The slot of `tok` in a table of `cap` keys, inserting it if new.
__device__ __forceinline__ int slot_of(int* keys, int cap, int shift,
                                       int tok) {
  volatile int* vk = keys;
  const int key = tok + 1;
  int h = (int)(((unsigned)tok * 2654435761u) >> shift);
  for (;;) {
    const int k = vk[h];
    if (k == key) return h;
    if (k == 0) {
      const int prev = atomicCAS(keys + h, 0, key);
      if (prev == 0 || prev == key) return h;
    }
    h = (h + 1) & (cap - 1);
  }
}

__global__ void __launch_bounds__(kThreads)
history_pass_kernel(const Params p) {
  extern __shared__ int smem[];
  __shared__ int tail[kMaxMatch + 1];
  __shared__ int brk[kMaxBreakers];
  __shared__ int s_window;
  const int tid = threadIdx.x, cap = p.cap;
  const int shift = 32 - (__ffs(cap) - 1);
  const bool in_smem = p.table == nullptr;
  int* keys = in_smem ? smem : p.table + (size_t)blockIdx.x * 4 * cap;
  int* dry = keys + cap;
  int* pcount = keys + 2 * cap;
  int* ocount = keys + 3 * cap;
  const bool dry_stage = p.stages & kDry, pen = p.stages & kPenalties,
             ng_stage = p.stages & kNgram;

  for (int r = blockIdx.x; r < p.R; r += gridDim.x) {
    const int* row = p.seq + (size_t)r * p.L;
    const int T = min(p.total_len[r], p.L), P = min(p.prompt_len[r], p.L);
    const int end = T - 1;
    // Positions any stage reads: [0, T), and the prompt's under penalties.
    const int n = max(pen ? max(T, P) : T, 0);
    const int* h = row;
    if (in_smem) {
      int* hist = smem + 4 * cap;
      for (int k = tid; k < 4 * cap; k += kThreads) keys[k] = 0;
      for (int k = tid; k < n; k += kThreads) hist[k] = row[k];
      h = hist;
    }
    if (tid < kMaxBreakers) brk[tid] = p.breakers[r * kMaxBreakers + tid];
    __syncthreads();
    if (tid < 32) {
      // The tail, and DRY's window: the first i in [0, 64] whose position
      // end - i is a breaker or before the history, else 65.
      int first = kMaxMatch + 1;
      for (int base = 0; base <= kMaxMatch; base += 32) {
        const int i = base + tid;
        bool stop = false;
        if (i <= kMaxMatch) {
          const int pos = end - i;
          const int tok = pos >= 0 ? h[pos] : -1;
          tail[i] = tok;
          stop = pos < 0 || (dry_stage && is_breaker(brk, tok));
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, stop);
        if (first > kMaxMatch && ballot) first = base + __ffs(ballot) - 1;
      }
      if (tid == 0) s_window = first;
    }
    __syncthreads();

    const int window = s_window;
    const float mult = p.dry_mult[r];
    const int allowed = p.dry_allowed[r], ngram = p.ngram[r];
    const bool dry_on = dry_stage && mult > 0.f && window > allowed && T >= 2;
    const bool ng_on = ng_stage && ngram > 0 && T >= ngram;
    const int dry_cap = dry_on ? max(window - 1, 0) : 0;
    const int need = min(kMaxMatch, max(dry_cap, ng_on ? ngram - 2 : 0));
    const int range = p.dry_range[r];
    const int range_start = range > 0 ? T - range : 0;
    const int last = end >= 0 ? h[end] : -1;
    const bool match = dry_on || ng_on;
    const int n_pos = pen ? n : max(end, 0);

    for (int j = tid; j < n_pos; j += kThreads) {
      const int tok = h[j];
      if (pen && tok >= 0 && tok < p.V && j < n) {
        const int s = slot_of(keys, cap, shift, tok);
        if (j < P) {
          atomicAdd(pcount + s, 1);
        } else if (j < T) {
          atomicAdd(ocount + s, 1);
        }
      }
      if (!match || j >= end || tok != last) continue;
      // The suffix matches ending at j - 1 against the tail, as far as the
      // row reads them; m_break also stops at a breaker.
      int mp = 0, mb = 0;
      bool alive_b = true;
      for (int u = 1; u <= need && j - u >= 0; ++u) {
        const int src = h[j - u];
        if (src != tail[u]) break;
        ++mp;
        if (alive_b) {
          if (dry_on && is_breaker(brk, src)) {
            alive_b = false;
          } else {
            ++mb;
          }
        }
      }
      const int nxt = h[j + 1];
      if (nxt < 0 || nxt >= p.V) continue;
      const int m = min(mb, dry_cap);
      const bool dry_hit = dry_on && j >= range_start && m > 0;
      const bool ban = ng_on && mp >= ngram - 2 && j >= ngram - 2;
      if (!dry_hit && !ban) continue;
      const int s = slot_of(keys, cap, shift, nxt);
      if (dry_hit) atomicMax(dry + s, m + 1);
      if (ban) atomicOr(pcount + s, kBan);
    }
    __syncthreads();

    // One thread a touched token: DRY -> penalties -> ban, in the plain
    // version's fp32 operations and order.
    const float base = p.dry_base[r], rep_pen = p.repetition[r],
                freq = p.frequency[r], pres = p.presence[r];
    float* lrow = p.logits + (size_t)r * p.V;
    volatile int* vt = keys;
    for (int s = tid; s < cap; s += kThreads) {
      const int key = vt[s];
      if (key == 0) continue;
      const int d = vt[cap + s], pc = vt[2 * cap + s], oc = vt[3 * cap + s];
      float x = lrow[key - 1];
      if (d > 0) {
        x = __fsub_rn(x, __fmul_rn(mult, powf(base, (float)(d - allowed))));
      }
      if (pen) {
        const float rep = ((pc & kCountMask) > 0 || oc > 0) ? rep_pen : 1.0f;
        x = x > 0.f ? __fdiv_rn(x, rep) : __fmul_rn(x, rep);
        x = __fsub_rn(x, __fmul_rn(freq, (float)oc));
        x = __fsub_rn(x, __fmul_rn(pres, oc > 0 ? 1.0f : 0.0f));
      }
      if (pc & kBan) x = -INFINITY;
      lrow[key - 1] = x;
      if (!in_smem) {  // leave the device-memory table zero
        vt[s] = 0;
        vt[cap + s] = 0;
        vt[2 * cap + s] = 0;
        vt[3 * cap + s] = 0;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launch over `blocks` blocks (a grid-stride loop over the R rows). `table`
// null: each block's table and the row's history in `4 * cap + L` ints of
// dynamic shared memory; else `blocks * 4 * cap` zeroed ints of device
// memory, left zero.
extern "C" int history_pass_launch(
    void* logits, const void* seq, const void* prompt_len,
    const void* total_len, const void* breakers, const void* dry_mult,
    const void* dry_base, const void* dry_allowed, const void* dry_range,
    const void* ngram, const void* presence, const void* frequency,
    const void* repetition, void* table, int R, int V, int L, int cap,
    int stages, int blocks, void* stream) {
  if (R <= 0 || V <= 0) return (int)cudaSuccess;
  if (L <= 0 || cap < 64 || (cap & (cap - 1)) != 0 || blocks <= 0 ||
      blocks > R || (stages & ~(kDry | kPenalties | kNgram)) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      table ? 0 : (size_t)(4 * cap + L) * sizeof(int);
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        history_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  Params p;
  p.logits = static_cast<float*>(logits);
  p.seq = static_cast<const int*>(seq);
  p.prompt_len = static_cast<const int*>(prompt_len);
  p.total_len = static_cast<const int*>(total_len);
  p.breakers = static_cast<const int*>(breakers);
  p.dry_mult = static_cast<const float*>(dry_mult);
  p.dry_base = static_cast<const float*>(dry_base);
  p.dry_allowed = static_cast<const int*>(dry_allowed);
  p.dry_range = static_cast<const int*>(dry_range);
  p.ngram = static_cast<const int*>(ngram);
  p.presence = static_cast<const float*>(presence);
  p.frequency = static_cast<const float*>(frequency);
  p.repetition = static_cast<const float*>(repetition);
  p.table = static_cast<int*>(table);
  p.V = V;
  p.L = L;
  p.R = R;
  p.cap = cap;
  p.stages = stages;
  history_pass_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
