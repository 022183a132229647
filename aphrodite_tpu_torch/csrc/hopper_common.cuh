// Hopper's asynchronous machinery, shared by the kernels that use it (the
// grouped GEMM, the weight-only decode GEMMs and the MLA attention
// instances): mbarriers (local and
// across a cluster), cluster rank and barrier, TMA tensor loads (multicast
// too) and stores with their bulk groups, the wgmma shared-memory
// descriptor and products (A from shared memory or from registers), and
// setmaxnreg, as raw PTX in the style of mma_common.cuh; and a host helper
// that encodes a CUtensorMap of any element type. sm_90a only (wgmma and
// setmaxnreg do not exist for plain sm_90).
//
// Layouts, all with the 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B
// and wgmma's layout type 1 agree on it when a tile starts on a 1024-byte
// boundary: 16-byte chunk c of 128-byte row r lands at chunk c ^ (r % 8)):
// - K-major operand (A = x, rows of 64 bf16 along K): a 64-row slab is 64
//   rows of 128 bytes; the descriptor's stride byte offset is 1024 (one
//   8-row group to the next), its leading byte offset unused; a k16 step
//   moves the start address by 32 bytes.
// - MN-major operand (B = w as [K, N], N contiguous): a box is 64 K rows of
//   64 N values (128 bytes); the stride byte offset is 1024 (one 8-row K
//   group to the next), the leading byte offset the distance from one
//   64-wide N chunk to the next (the next box); a k16 step moves the start
//   address by 16 rows, 2048 bytes. The product's transpose-B immediate is
//   1.
// - K-major B (x as [M, K] with M the product's N, rows of 64 bf16 along
//   K), for the products whose A comes from registers: laid out and
//   described as the K-major A above (stride byte offset 1024, a k16 step
//   32 bytes); transpose-B immediate 0.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0, so a wait on parity 1 passes at once: a producer waits on
// its "empty" barriers with parity phase ^ 1, a consumer on its "full"
// barriers with parity phase, both flipping `phase` when the ring wraps.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Arrive on the barrier at the same shared-memory offset in block `cta` of
// this block's cluster (this block's own rank included).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}

// -------------------------------------------------------------- clusters
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster; orders what each did before
// (barrier initialisation) before what any does after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// ------------------------------------------------------------ TMA loads
// One thread asks for a box of the tensor `map` (a __grid_constant__
// kernel parameter) at the given coordinates, innermost first; the bytes
// land in shared memory at `dst` and complete a transaction on `bar`.
// Coordinates past the tensor's edge read zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The same box written at `dst` in every block of the cluster named in
// `cta_mask`, completing a transaction on the barrier at `bar`'s offset in
// each of them.
__device__ __forceinline__ void tma_load_3d_multicast(
    void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
    uint16_t cta_mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "h"(cta_mask)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d_multicast(
    void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
    uint16_t cta_mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "h"(cta_mask)
      : "memory");
}

// A box of shared memory at `src` written to the tensor `map` at the given
// coordinates; what lies past the tensor's edge is not written. The store
// joins this thread's current bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read shared
// memory (their global writes may still be on the way).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until at most N of this thread's bulk groups are unfinished.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's ordinary shared-memory writes visible to the async
// proxy (TMA stores, wgmma) of the threads that synchronise with it after.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ----------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units), layout type 1 in bits
// 62-63. The base-offset field stays 0: every tile starts on a 1024-byte
// boundary.
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// Orders this warpgroup's register and shared-memory accesses before the
// products that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that write it.
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d[0, 128) += A (64 x 16, K-major) * B (16 x 256, MN-major), both of the
// element type T (__nv_bfloat16 or __half), read from shared memory through
// descriptors; scale_d == 0 ignores d. The asm is written once
// (HOPPER_WGMMA_SS_256) with the operand type a string.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n256k16_tb(float* d, uint64_t da,
                                                    uint64_t db, int scale_d);

#define HOPPER_WGMMA_SS_256(TY)                                                \
  asm volatile(                                                                \
      "{\n"                                                                    \
      ".reg .pred p;\n"                                                        \
      "setp.ne.b32 p, %130, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                        \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                                \
      "%24, %25, %26, %27, %28, %29, %30, %31,"                                \
      "%32, %33, %34, %35, %36, %37, %38, %39,"                                \
      "%40, %41, %42, %43, %44, %45, %46, %47,"                                \
      "%48, %49, %50, %51, %52, %53, %54, %55,"                                \
      "%56, %57, %58, %59, %60, %61, %62, %63,"                                \
      "%64, %65, %66, %67, %68, %69, %70, %71,"                                \
      "%72, %73, %74, %75, %76, %77, %78, %79,"                                \
      "%80, %81, %82, %83, %84, %85, %86, %87,"                                \
      "%88, %89, %90, %91, %92, %93, %94, %95,"                                \
      "%96, %97, %98, %99, %100, %101, %102, %103,"                            \
      "%104, %105, %106, %107, %108, %109, %110, %111,"                        \
      "%112, %113, %114, %115, %116, %117, %118, %119,"                        \
      "%120, %121, %122, %123, %124, %125, %126, %127"                         \
      "}, %128, %129, p, 1, 1, 0, 1;\n"                                        \
      "}\n"                                                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),       \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),       \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),       \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),       \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),       \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),       \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),       \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),       \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),       \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),       \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),       \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),  \
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),  \
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),  \
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),  \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),  \
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                               \
      : "l"(da), "l"(db), "r"(scale_d));

template <>
__device__ __forceinline__ void wgmma_m64n256k16_tb<__nv_bfloat16>(
    float* d, uint64_t da, uint64_t db, int scale_d) {
  HOPPER_WGMMA_SS_256("bf16");
}

template <>
__device__ __forceinline__ void wgmma_m64n256k16_tb<__half>(
    float* d, uint64_t da, uint64_t db, int scale_d) {
  HOPPER_WGMMA_SS_256("f16");
}

// d[0, N / 2) += A (64 x 16) * B (16 x N, K-major, read through db), both
// of the element type T (__nv_bfloat16 or __half); A is this thread's
// fragment of four pairs, laid out as mma.sync's A (mma_common.cuh) for
// rows [16 w, 16 w + 16) of warp w of the warpgroup; d as the
// shared-memory form's (d[4 j + 2 h + i]: row 16 w + lane / 4 + 8 h,
// column 8 j + 2 (lane % 4) + i). scale_d == 0 ignores d. The registers of
// a and d must stay untouched until the product is waited for. Each N's
// asm is written once (HOPPER_WGMMA_RS_N) with the operand type a string.
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db, int scale_d);

#define HOPPER_WGMMA_RS_16(TY)                                      \
  asm volatile(                                                     \
      "{\n"                                                         \
      ".reg .pred p;\n"                                             \
      "setp.ne.b32 p, %13, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7"                              \
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"                   \
      "}\n"                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),        \
        "r"(scale_d));

template <>
__device__ __forceinline__ void wgmma_rs<16, __nv_bfloat16>(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  HOPPER_WGMMA_RS_16("bf16");
}

template <>
__device__ __forceinline__ void wgmma_rs<16, __half>(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  HOPPER_WGMMA_RS_16("f16");
}

#define HOPPER_WGMMA_RS_32(TY)                                           \
  asm volatile(                                                          \
      "{\n"                                                              \
      ".reg .pred p;\n"                                                  \
      "setp.ne.b32 p, %21, 0;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"       \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                  \
      "%8, %9, %10, %11, %12, %13, %14, %15"                             \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"                      \
      "}\n"                                                              \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),      \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15])                                                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),             \
        "r"(scale_d));

template <>
__device__ __forceinline__ void wgmma_rs<32, __nv_bfloat16>(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  HOPPER_WGMMA_RS_32("bf16");
}

template <>
__device__ __forceinline__ void wgmma_rs<32, __half>(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  HOPPER_WGMMA_RS_32("f16");
}

#define HOPPER_WGMMA_RS_64(TY)                                           \
  asm volatile(                                                          \
      "{\n"                                                              \
      ".reg .pred p;\n"                                                  \
      "setp.ne.b32 p, %37, 0;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"       \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                  \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                            \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                          \
      "%24, %25, %26, %27, %28, %29, %30, %31"                           \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"                      \
      "}\n"                                                              \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),      \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31])                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),             \
        "r"(scale_d));

template <>
__device__ __forceinline__ void wgmma_rs<64, __nv_bfloat16>(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  HOPPER_WGMMA_RS_64("bf16");
}

template <>
__device__ __forceinline__ void wgmma_rs<64, __half>(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  HOPPER_WGMMA_RS_64("f16");
}

#define HOPPER_WGMMA_RS_128(TY)                                          \
  asm volatile(                                                          \
      "{\n"                                                              \
      ".reg .pred p;\n"                                                  \
      "setp.ne.b32 p, %69, 0;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"      \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                  \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                            \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                          \
      "%24, %25, %26, %27, %28, %29, %30, %31,"                          \
      "%32, %33, %34, %35, %36, %37, %38, %39,"                          \
      "%40, %41, %42, %43, %44, %45, %46, %47,"                          \
      "%48, %49, %50, %51, %52, %53, %54, %55,"                          \
      "%56, %57, %58, %59, %60, %61, %62, %63"                           \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"                      \
      "}\n"                                                              \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),      \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),             \
        "r"(scale_d));

template <>
__device__ __forceinline__ void wgmma_rs<128, __nv_bfloat16>(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  HOPPER_WGMMA_RS_128("bf16");
}

template <>
__device__ __forceinline__ void wgmma_rs<128, __half>(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  HOPPER_WGMMA_RS_128("f16");
}

// ------------------------------------------------------------ setmaxnreg
// A warpgroup's register budget a thread, moved between warpgroups: a
// producer gives registers back, consumers take them. All four warps of the
// warpgroup execute it; the kernel's roles must not reconverge after it.
template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ------------------------------------------------------------------ host
// Encode a tensor map: `rank` dimensions, innermost first, their byte
// strides (rank - 1 of them, dimension 0 being contiguous), the box, the
// element type and the swizzle. cuTensorMapEncodeTiled lives in libcuda,
// which the library does not link: the runtime hands out its address once.
// Returns cudaErrorInvalidValue where the map is refused (misaligned base,
// stride not a multiple of 16 bytes, box too large for the swizzle).
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline cudaError_t encode_tiled_fn(EncodeTiledFn* out) {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  *out = fn;
  return cudaSuccess;
}

inline cudaError_t make_tma_map(CUtensorMap* map, CUtensorMapDataType type,
                                const void* base, int rank,
                                const uint64_t* dims,
                                const uint64_t* strides_bytes,
                                const uint32_t* box,
                                CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn;
  const cudaError_t err = encode_tiled_fn(&fn);
  if (err != cudaSuccess) return err;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides_bytes[i];
  }
  const CUresult r = fn(map, type, static_cast<cuuint32_t>(rank),
                        const_cast<void*>(base), d, s, b, e,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor-map element type of a 16-bit element T (__nv_bfloat16 or
// __half).
template <typename T>
constexpr CUtensorMapDataType kTmaType =
    std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// A map of 16-bit elements T with the 128-byte swizzle.
template <typename T>
inline cudaError_t make_tma_map_16(CUtensorMap* map, const void* base,
                                   int rank, const uint64_t* dims,
                                   const uint64_t* strides_bytes,
                                   const uint32_t* box) {
  return make_tma_map(map, kTmaType<T>, base, rank, dims, strides_bytes, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

// A one-byte map (fp8 or int8 bytes) without a swizzle: a box lands as
// its rows one after another, box[0] bytes each (a multiple of 16, at most
// 256), 128-byte aligned in shared memory.
inline cudaError_t make_tma_map_bytes(CUtensorMap* map, const void* base,
                                      int rank, const uint64_t* dims,
                                      const uint64_t* strides_bytes,
                                      const uint32_t* box) {
  return make_tma_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, rank, dims,
                      strides_bytes, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace hopper
