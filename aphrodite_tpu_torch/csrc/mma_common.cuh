// Tensor-core and asynchronous-copy helpers shared by the bf16 kernels
// (attention, grouped GEMM, quantized GEMMs): 16-byte cp.async into shared
// memory, ldmatrix fragments and mma.sync m16n8k16 (bf16 or fp16 in, fp32
// accumulate), and the host's shared-memory opt-in. Fragment layouts, for lane l, g = l / 4 and t = l % 4:
//   A (16 x 16, row-major): a0 (row g, k 2t..2t+1), a1 (row g + 8, same k),
//     a2 (row g, k 2t + 8..), a3 (row g + 8, k 2t + 8..);
//   B (16 x 8, k x n): b0 (k 2t..2t+1, col g), b1 (k 2t + 8.., col g);
//   C (16 x 8): c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row g + 8).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mma {

// Copy 16 bytes from global to shared memory without staging them in
// registers; valid == false fills the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 b16 matrices: lanes 8i..8i+7 address the rows of matrix i,
// and r[i] receives this lane's part of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a * b on one 16 x 8 x 16 tile.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The same with fp16 operands (the attention kernels' fp16 instances).
__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a,
                                        const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b with operands of the element type T (__nv_bfloat16 or
// __half): one source serves both instances of a kernel.
template <typename T>
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  if constexpr (std::is_same<T, __half>::value) mma_f16(c, a, b);
  else mma_bf16(c, a, b);
}

// 2^x by the special-function unit (ex2.approx: 2 ulp; 2^-inf = +0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats rounded to fp16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats rounded to T (__nv_bfloat16 or __half) in one register.
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) return pack_f16(lo, hi);
  else return pack_bf16(lo, hi);
}

// Raise a kernel's dynamic shared memory limit to `bytes`, calling the
// runtime only when the limit grows (the call costs host time per launch).
// The default limit leaves no room above 48 KB, so the first launch of a
// kernel that needs more always sets it.
template <auto kKernel>
cudaError_t allow_smem(int bytes) {
  static int allowed = 0;  // one per kernel
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

}  // namespace mma
