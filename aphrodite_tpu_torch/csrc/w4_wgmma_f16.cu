// The weight-only decode GEMMs' fp16 instances (w4_wgmma_kernel with T =
// __half: fp16 x and y, products f32.f16.f16, the weights converted to
// fp16 in registers), CUDA, sm_90a. csrc/w4_wgmma.cuh describes the
// kernel; the weights' tensor maps come from csrc/w4_wgmma.cu's
// w4_weight_maps. The timing variants (W4_DROP, W8_CONVERT) are bf16's
// only.
#include "w4_wgmma.cuh"

#if W4_DROP != 0 || W8_CONVERT != 0
#error "the timing variants build the bf16 instances only (w4_wgmma.cu)"
#endif

// w4_wgmma_f16_launch: y = x @ W for fp16 x and y (p[13] == 2); the
// arguments as launch_entry's.
extern "C" int w4_wgmma_f16_launch(const int* p, const void* maps,
                                   const void* x, void* out, float* partial,
                                   int* counters, const float* col_scales,
                                   const float* row_scales, void* stream) {
  return launch_entry<__half>(p, maps, x, out, partial, counters, col_scales,
                              row_scales, stream);
}
