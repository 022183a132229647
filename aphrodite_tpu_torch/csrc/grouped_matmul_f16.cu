// The grouped GEMM's fp16 instance (gmm_wgmma_kernel with T = __half: fp16
// x, w and y, products f32.f16.f16, y rounded once to fp16), CUDA, sm_90a.
// csrc/grouped_matmul.cuh describes the kernel.
#include "grouped_matmul.cuh"

// Entry point (ctypes): y = x @ w[group] for fp16 x, w and out (dtype must
// be 2, the attention kernels' code of fp16); the other arguments and the
// return value as grouped_matmul_launch's (csrc/grouped_matmul.cu).
extern "C" int grouped_matmul_f16_launch(int dtype, const void* x,
                                         const void* w, const int* offsets,
                                         void* out, int M, int K, int N,
                                         int E, int grid, void* stream) {
  return launch_wgmma<__half>(dtype, x, w, offsets, out, M, K, N, E, grid,
                              static_cast<cudaStream_t>(stream));
}
