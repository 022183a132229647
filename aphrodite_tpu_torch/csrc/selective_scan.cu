// Selective scan (CUDA, sm_90a): the Mamba first-order linear recurrence
//
//     hs[t] = dA[t] * hs[t-1] + dBx[t],   hs[-1] = 0,
//
// elementwise over C columns of row-major fp32 [T, C] inputs.
//
// Replaces the TPU kernel `selective_scan` / `_scan_kernel` of
// aphrodite_tpu/ops/selective_scan.py. The TPU kernel runs a Hillis-Steele
// scan inside each [bt, bc] VMEM block and carries the state from one
// T-chunk to the next in scratch along a sequential grid axis. Hopper runs
// blocks in no order, so here the loop over T lives inside the thread.
//
// Segments. The kernel knows nothing of requests: the caller
// (models/mamba.py) zeroes dA at each segment's first token and folds the
// resumed state into dBx there, so a dA = 0 row restarts the recurrence.
//
// Design. Thread c owns column c and walks t = 0..T-1 with the state in a
// register. Neighbouring threads read neighbouring columns of one row, so
// every load and store is coalesced. Loads run kUnroll rows ahead of the
// arithmetic to keep bytes in flight. The product and the sum round
// separately (__fmul_rn, __fadd_rn: no FMA contraction), so the kernel
// equals, bit for bit, the in-order plain version that PyTorch runs as a
// multiply then an add.
//
// Bound. 12 bytes an element: dA and dBx read once, hs written once. At
// the Mamba-2.8B prefill wave (T = 4096, C = 5120 x 16 = 81920) that is
// 4.03 GB, 1.20 ms at 3.35 TB/s. 81920 columns make 640 blocks of 128
// threads, which all fit on the 132 SMs at once. At small C (decode of a
// narrow model) the card sits mostly idle: a chunked two-pass scan over T
// is the fix for that. The larger gain is elsewhere: the caller still
// builds exp(dt * A), dt * B * x and the hs * C contraction as [T, Di, Ds]
// tensors in device memory; fusing those into this kernel, so that the
// [T, Di, Ds] tensors never leave the SM, is the later redesign.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ dA, const float* __restrict__ dBx,
            float* __restrict__ hs, int T, long long C) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const float* a_p = dA + c;
  const float* b_p = dBx + c;
  float* h_p = hs + c;
  float h = 0.f;
  int t = 0;
  for (; t + kUnroll <= T; t += kUnroll) {
    float a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = __ldg(a_p + (size_t)(t + u) * C);
      b[u] = __ldg(b_p + (size_t)(t + u) * C);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(a[u], h), b[u]);
      h_p[(size_t)(t + u) * C] = h;
    }
  }
  for (; t < T; ++t) {
    h = __fadd_rn(__fmul_rn(__ldg(a_p + (size_t)t * C), h),
                  __ldg(b_p + (size_t)t * C));
    h_p[(size_t)t * C] = h;
  }
}

}  // namespace

extern "C" int selective_scan_launch(const void* dA, const void* dBx,
                                     void* hs, int T, long long C,
                                     void* stream) {
  if (T <= 0 || C <= 0) return (int)cudaSuccess;
  const long long blocks = (C + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scan_kernel<<<(unsigned)blocks, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dA), static_cast<const float*>(dBx),
      static_cast<float*>(hs), T, C);
  return (int)cudaGetLastError();
}
