// The grouped GEMM's bf16 instance of gmm_wgmma_kernel and its fp32
// CUDA-core kernel (CUDA, sm_90a). csrc/grouped_matmul.cuh describes the
// product and the wgmma kernel, whose element type T is a template
// parameter; the fp16 instance is built in csrc/grouped_matmul_f16.cu, a
// translation unit of its own, so that nvcc compiles the two side by side.
#include "grouped_matmul.cuh"

namespace {

// -------------------------------------------------------------- fp32 kernel
constexpr int kThreads = 256;
constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(kThreads)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ offsets, float* __restrict__ out,
               int M, int K, int N, int E) {
  int group, row_lo, row_hi;
  if (!find_item<kFM>(offsets, E, M, blockIdx.y, group, row_lo, row_hi))
    return;
  __shared__ float a_s[kFK][kFM + 4];  // [k][row]
  __shared__ float b_s[kFK][kFN + 4];  // [k][col]
  const int m0 = row_lo - row_lo % kFM;
  const int n0 = blockIdx.x * kFN;
  const float* wg = w + (size_t)group * K * N;
  // Thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j.
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
    for (int q = 0; q < kFM * kFK / kThreads; ++q) {
      const int i = threadIdx.x + q * kThreads;
      const int r = i / kFK, c = i % kFK;
      const int row = m0 + r, k = k0 + c;
      a_s[c][r] = (row >= row_lo && row < row_hi && k < K)
                      ? __ldg(x + (size_t)row * K + k)
                      : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kFK * kFN / kThreads; ++q) {
      const int i = threadIdx.x + q * kThreads;
      const int r = i / kFN, c = i % kFN;
      const int k = k0 + r, n = n0 + c;
      b_s[r][c] = (k < K && n < N) ? __ldg(wg + (size_t)k * N + n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row < row_lo || row >= row_hi) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(size_t)row * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// Entry point (ctypes). dtype: 0 fp32, 1 bf16 (x, w and out alike; fp16,
// code 2, is grouped_matmul_f16_launch's); offsets int32 [E + 1] on the
// device. bf16 launches min(grid, tiles) persistent blocks (grid: the
// card's SM count), fp32 one block per work item and 64-column tile, on
// `stream`. Returns a cudaError_t (cudaErrorInvalidValue for arguments the
// kernels do not take: bf16 needs K and N multiples of 8 and 16-byte
// aligned x and w).
extern "C" int grouped_matmul_launch(int dtype, const void* x, const void* w,
                                     const int* offsets, void* out, int M,
                                     int K, int N, int E, int grid,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_wgmma<__nv_bfloat16>(dtype, x, w, offsets, out, M, K, N, E,
                                       grid, s);
  if (M < 1 || K < 1 || N < 1 || E < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    const long items = (M + kFM - 1) / kFM + (long)E - 1;
    if (items > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid2((N + kFN - 1) / kFN, (unsigned)items);
    gmm_f32_kernel<<<grid2, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), offsets,
        static_cast<float*>(out), M, K, N, E);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
