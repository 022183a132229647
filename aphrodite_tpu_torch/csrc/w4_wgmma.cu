// The weight-only decode GEMMs' bf16 instances and the weights' tensor
// maps (CUDA, sm_90a). csrc/w4_wgmma.cuh describes the kernel, whose
// element type T is a template parameter; the fp16 instances are built in
// csrc/w4_wgmma_f16.cu, a translation unit of their own, so that nvcc
// compiles the two sets side by side.
#include "w4_wgmma.cuh"

// Entry points (ctypes); each returns a cudaError_t.
//
// w4_weight_maps: the three tensor maps of one weight, written to `maps`
// (3 x 128 bytes, any alignment), encoded once per weight by the caller:
// the bytes q [rows, N] (rows = K/2 for int4 and packed, K for uint4, w8
// and fp8) in boxes of 64 rows x 128 columns (128-byte swizzle; N a
// multiple of 16, TMA's row stride), then the fp32 scales and zeros [G, N]
// in boxes of gs rows x 128 columns; with gs = 0 (w8 and fp8, whose scales
// the epilogue reads) those two maps are left zero. The maps hold no
// element type of x: one weight's serve the bf16 and fp16 instances.
extern "C" int w4_weight_maps(const void* q, const float* scales,
                              const float* zeros, int rows, int N, int G,
                              int gs, void* maps) {
  if (rows < 1 || N < 16 || N % 16 != 0 || gs < 0 || gs > 256 ||
      (gs > 0 && G < 1))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[3];
  memset(m, 0, sizeof(m));
  const uint64_t w_dims[2] = {(uint64_t)N, (uint64_t)rows};
  const uint64_t w_strides[1] = {(uint64_t)N};
  const uint32_t w_box[2] = {kBN, kRows};
  cudaError_t err = make_tma_map(&m[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, q, 2,
                                 w_dims, w_strides, w_box,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  const uint64_t s_dims[2] = {(uint64_t)N, (uint64_t)G};
  const uint64_t s_strides[1] = {(uint64_t)N * 4};
  const uint32_t s_box[2] = {kBN, (uint32_t)gs};
  const void* sz[2] = {scales, zeros};
  for (int i = 0; i < 2 && gs > 0; ++i) {
    err = make_tma_map(&m[1 + i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sz[i], 2,
                       s_dims, s_strides, s_box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return (int)err;
  }
  memcpy(maps, m, sizeof(m));
  return (int)cudaSuccess;
}


// w4_wgmma_launch: y = x @ W for bf16 x and y (p[13] == 1); the arguments
// as launch_entry's (csrc/w4_wgmma.cuh).
extern "C" int w4_wgmma_launch(const int* p, const void* maps, const void* x,
                               void* out, float* partial, int* counters,
                               const float* col_scales,
                               const float* row_scales, void* stream) {
  return launch_entry<__nv_bfloat16>(p, maps, x, out, partial, counters,
                                     col_scales, row_scales, stream);
}
