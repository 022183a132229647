// Weight-only decode GEMMs on Hopper's warpgroup products (CUDA, sm_90a):
//   y[M, N] = x[M, K] @ W, x and y of one element type T, bf16 or fp16 (a
//   template parameter: the TPU kernels compute in x's dtype and return
//   it, quant_matmul_pallas.py:38-40, 76), M <= 256, W stored one weight
//   in a nibble or in a byte. Five layouts of one main loop:
//
//   kInt4   <- w4a16_int4_matmul_pallas (:290) / _w4i4_kernel (:263) of
//              aphrodite_tpu/ops/quant_matmul_pallas.py: q signed int4
//              (q - 8) as uint8 [K/2, N], rows 2r and 2r + 1 in the low and
//              high nibble of byte [r, n] (two's complement), zeros z - 8;
//   kPacked <- w4a16_packed_matmul_pallas (:206) / _w4p_kernel (:163): q
//              uint4 as uint8 [K/2, N], row r in the low nibble and row
//              r + K/2 in the high nibble of byte [r, n];
//   kUint4  <- w4a16_matmul_pallas (:119) / _w4_kernel (:85): q uint4, one
//              byte a weight, int8 [K, N];
//   kW8     <- w8a16_matmul_pallas (:50) / _w8_kernel (:31): q int8 [K, N],
//              one fp32 scale a column, s [N], no zeros;
//   kFp8    <- no Pallas kernel: fp8_matmul of aphrodite_tpu/ops/
//              quant_gemm.py:74-119 (XLA computes it in JAX): q e4m3fn
//              [K, N], one fp32 scale a column, s [N], no zeros; with the
//              template switch RS, also one fp32 scale a row of x, rs [M]
//              (W8A8: x already rounded to e4m3 and held in T, which is
//              exact), and y = (d rs[m]) s[n] in fp32, the reference's
//              order (quant_gemm.py:112-118).
// The first three are W[k, n] = (q[k, n] - z[g, n]) s[g, n], g = k / group,
// s and z fp32 [K / group, N]; kW8 and kFp8 are W[k, n] = q[k, n] s[n]. The
// three byte layouts ("one byte a weight") are a third case of the same
// stage: one byte row is one k, as each of kPacked's halves; kFp8 has kW8's
// geometry. (fp32 activations stay on the CUDA-core kernels of
// quant_matmul.cu.)
//
// This header holds the kernel and its launch; csrc/w4_wgmma.cu builds the
// bf16 instances (and the weights' tensor maps), csrc/w4_wgmma_f16.cu the
// fp16 ones, side by side. What T changes is small and named (Elem<T>):
// the products (wgmma's f32.bf16.bf16 or f32.f16.f16 form), the ones of
// the sums of x, the magic number of the nibble conversion, the int8 and
// e4m3 conversions, x's tensor map and the rounding of y.
//
// Form: the TPU int4 kernel's group-wise one. Per group (and per half of K
// for kPacked) d = x_g @ q_g, with q exact in T and d summed in fp32 by
// the tensor cores; then acc += (d - sum(x_g) z) s in fp32. Scales touch
// the [M, N] group result, never a weight. A fold may cover part of a group
// (a stage, a K split): the parts add up to the same sum. Where every zero
// is an integer (as the quantizers make them), the template switch ZI takes
// the zero inside the product instead: q - z is an integer, exact in T
// where it is at most 256 (bf16) or 2048 (fp16) in magnitude, and so is
// the conversion's subtrahend (ops/w4_wgmma.py's zeros_integral), so
// d = x_g @ (q_g - z_g) is the same sum of exact
// products, and acc += d s. That drops the sums of x, which cost a third of
// the time at M = 128 (PERF.md): the tensor cores and the shared memory
// that read x once more. The caller reads the zeros at a weight's first
// call at each M. kW8 and kFp8 have no groups: d sums a split's whole
// range and the epilogue takes y = d s, as _w8_kernel scales its fp32 sum.
//
// Bound. At the Llama-3.1-8B int4 path's decode M = 128 a layer's four
// GEMMs take 55.8 GFLOP (~56 us at 989 TFLOP/s) and read ~123 MB (~37 us
// at 3.35 TB/s): operations bind. At M = 32 the bytes bind: ~38 us packed,
// ~65 us for the W8 layer (~218 MB), ~74 us for a Qwen2.5-7B uint4 layer
// (~248 MB with its scales and zeros). So the product runs on wgmma, and
// the weights stream through a TMA ring deep enough to keep the memory busy
// at small M.
//
// The product is taken transposed, y^T = W^T x^T, with wgmma m64nMTk16:
// A (64 rows = 64 columns of W, 16 k) comes from registers, B = x from
// shared memory (K-major: x's own layout, 128-byte swizzle), its N the MT
// rows of M (16, 32, 64 or 128; M in (128, 256] takes two M tiles).
//
// Block: 3 warpgroups, 128 columns of W, clusters of 2 blocks side by
// side on N.
// - Warp 0 (producer, setmaxnreg 56) fills a ring of stages under "full"
//   and "empty" mbarriers by TMA. A stage holds 64 byte rows of the
//   weights (128 columns, 128-byte swizzle), the stage's scales and zeros
//   (none for kW8) and the x boxes of MT rows x 64 k it multiplies: kInt4's
//   k [2 r0, 2 r0 + 128), kPacked's [r0, r0 + 64) and [K/2 + r0, ...), the
//   byte layouts' one box [r0, r0 + 64). Both blocks of a cluster need the
//   same x: block b loads box b and multicasts it to both, which halves x's
//   L2 reads (at M = 128, x is 4x the weights' bytes a tile). So every
//   consumer warp releases a stage in both blocks.
// - Without ZI, warps 1-3 sum x over each fold's k range as a stage lands
//   and signal a "sums" mbarrier: on the tensor cores, mma.sync with x as
//   A (16 rows of M) and ones as B, fp32 sums as d's (on the CUDA cores
//   the sums, ~2 instructions a value of x, held the consumers back:
//   PERF.md).
// - Warpgroups 1 and 2 (consumers, setmaxnreg 224) own 64 columns each.
//   Per k16 step a warp takes its 16 columns' bytes with one ldmatrix
//   (.trans: lane (g, t) gets columns 2g, 2g + 1 of two byte rows, so A
//   row g stands for column 2g and row g + 8 for 2g + 1) and makes its A
//   fragment. A nibble pair becomes two exact values of T by an OR into
//   the magic number c, whose ulp is 1 (bf16 0x4300, 128; fp16 0x6400,
//   1024): c + u; then one subtraction of a pair (of c + 8 for int4, whose
//   nibble is xor'd with 8 on the way, or of c). kInt4's byte already holds one
//   register's k pair (its ldmatrix rows are byte rows t and t + 4); the
//   others take a pair from two consecutive byte rows (k and k + 1):
//   kPacked the same nibble of both, low nibbles with x's first half, high
//   nibbles, in a second pass over the stage, with its second; kUint4 the
//   low nibble (its whole value) over all K, kPacked's first pass; kW8 the
//   whole signed byte b, which the bf16 trick cannot hold (128 + u is
//   exact only for u < 128): the fp32 of bits 0x4B000000 | (b ^ 0x80) is
//   2^23 + 128 + b, one fp32 subtraction leaves b, and a pair rounds to
//   bf16 exactly in one cvt (W8_CONVERT 0; the other two conversions
//   timed, 1 and 2 below, were no faster: PERF.md), while fp16 holds
//   1024 + 128 + b (0x6400 | (b ^ 0x80)) and one subtraction leaves b;
//   kFp8 the e4m3 byte,
//   exact in bf16 for every finite byte (the weights hold no NaN) by a bit
//   move, (b & 0x80) << 8 | (b & 0x7f) << 4, and one bf16x2 product with
//   2^120 (subnormals too: bf16 keeps them; the hardware's
//   cvt.rn.f16x2.e4m3x2 and f16 -> fp32 -> bf16, timed, was slower:
//   PERF.md), and in fp16 by that cvt alone, one exact instruction.
//   Each step has its own registers (a stage's half: 8 int4 or 4 steps of
//   the other layouts, 32 or 16 registers), so the next step is converted
//   while the products before it run. A fold's range (F steps, F a
//   template switch: 16 F divides the group and kPacked's half starts) is
//   one group of products, waited for, then folded: no branch lies inside
//   a group in flight (ptxas serialises wgmma across divergent paths), and
//   the other warpgroup's products run while this one folds. kW8 folds
//   nothing (one fold a stage, d kept across stages). A short last stage
//   runs whole too: TMA fills the rows past the end with zeros (and x past
//   K), and the sums of x stop at the last real row.
// - Epilogue: the sums go through shared memory (the ring, free by then)
//   and out in whole 16-byte pieces of rows of y. With K split across
//   blocks (grid y: N = 4096 alone gives 32 column tiles for 132 SMs) each
//   writes fp32 partial sums and the last block of a tile to finish adds
//   them in split order (deterministic).
// W4_DROP (a bit mask, 0 here) removes parts of the kernel, and W8_CONVERT
// picks kW8's conversion, for timing only (chip_smoke.py --variants, bf16
// only).
#pragma once

#include <cuda_fp8.h>
#include <string.h>

#include <type_traits>

#include "hopper_common.cuh"
#include "mma_common.cuh"

#ifndef W4_DROP
#define W4_DROP 0
#endif
// kW8's conversion: 0 the fp32 magic number above; 1 the sign split, b =
// l - 128 s with l its low 7 bits and s its sign bit, 0x4300 | l (128 + l)
// minus 0x4300 | (s << 7) (128 + 128 s) in one bf16x2 subtraction; 2 the
// byte split into a signed high and an unsigned low nibble, x @ q = x @
// (16 h) + x @ l, two products a step from the same x.
#ifndef W8_CONVERT
#define W8_CONVERT 0
#endif

namespace {

using namespace hopper;
using mma::allow_smem;
using mma::ldmatrix_x4;
using mma::mma16816;
using mma::pack;
using mma::pack_bf16;

enum Layout { kInt4 = 0, kPacked = 1, kUint4 = 2, kW8 = 3, kFp8 = 4 };

// What the element type T of x and y (__nv_bfloat16 or __half) changes:
// 1.0 twice (the sums of x' B operand); the magic number OR'd under a
// nibble, whose ulp is 1 (bf16 128, fp16 1024), twice; x's tensor map; and
// the entry's code of x's dtype (the attention kernels' codes: bf16 1,
// fp16 2).
template <typename T>
struct Elem {
  static constexpr bool kF16 = std::is_same<T, __half>::value;
  static constexpr uint32_t kOnes = kF16 ? 0x3C003C00u : 0x3F803F80u;
  static constexpr uint32_t kMagic = kF16 ? 0x64006400u : 0x43004300u;
  static constexpr float kMagicF = kF16 ? 1024.f : 128.f;
  static constexpr int kCode = kF16 ? 2 : 1;
  static constexpr CUtensorMapDataType kMap =
      kF16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// Parts that W4_DROP removes: the A conversion (A is zero), the fold's
// arithmetic (acc += d keeps the products alive), the multicast of x, the
// stores of y (a test of a sum of acc that never holds keeps them alive),
// the products, the loads, the sums of x, a K split's partial sums and
// their fix-up (y is then written only where the launch has no split).
constexpr int kDropConvert = 1, kDropFold = 2, kDropMulticast = 4,
              kDropStores = 8, kDropProducts = 16, kDropLoads = 32,
              kDropSums = 64, kDropPartials = 128;
__host__ __device__ constexpr bool dropped(int part) {
  return (W4_DROP & part) != 0;
}

constexpr int kBN = 128;          // columns of W a block
constexpr int kRows = 64;         // byte rows of W a stage
constexpr int kWBytes = kRows * kBN;
constexpr int kThreads = 384;     // producer warpgroup + 2 consumers
constexpr int kCluster = 2;
constexpr int kSumThreads = 96;   // warps 1-3
constexpr int kEmptyArrivals = kCluster * 8;  // consumer warps, both blocks
constexpr int kPitch = 64 + 4;    // fp32 row pitch of the epilogue's tile

__host__ __device__ constexpr bool one_byte(int layout) {
  return layout == kUint4 || layout == kW8 || layout == kFp8;
}
// No groups and no zeros: one fp32 scale a column, after the sum.
__host__ __device__ constexpr bool col_scaled(int layout) {
  return layout == kW8 || layout == kFp8;
}
// k16 steps in a stage's half.
__host__ __device__ constexpr int half_steps(int layout) {
  return layout == kInt4 ? 8 : 4;
}
__host__ __device__ constexpr int halves(int layout) {
  return layout == kPacked ? 2 : 1;
}
// x boxes (MT rows x 64 k) a stage multiplies.
__host__ __device__ constexpr int x_boxes(int layout) {
  return one_byte(layout) ? 1 : 2;
}
// Byte rows of W.
__host__ __device__ constexpr int byte_rows(int layout, int K) {
  return one_byte(layout) ? K : K / 2;
}
// Products a k16 step issues (A registers: 4 each).
__host__ __device__ constexpr int step_products(int layout) {
  return layout == kW8 && W8_CONVERT == 2 ? 2 : 1;
}

// Offsets in a stage (bytes): weights [64][128] at 0, x boxes of MT x 128
// bytes, scales and zeros [halves][gs][128] fp32 (gs = 0 for kW8), sums of
// x [halves][folds][MT] fp32; gs is the most groups a stage's half can
// touch, folds = half_steps / F. Mirrored by ops/w4_wgmma.py
// (stage_bytes).
struct StageGeo {
  int x_off, s_off, z_off, xs_off, bytes;
};

__host__ __device__ __forceinline__ StageGeo stage_geo(int layout, int mt,
                                                       int gs, int f) {
  StageGeo g;
  g.x_off = kWBytes;
  g.s_off = g.x_off + x_boxes(layout) * mt * 128;
  g.z_off = g.s_off + halves(layout) * gs * kBN * 4;
  g.xs_off = g.z_off + halves(layout) * gs * kBN * 4;
  g.bytes = (g.xs_off + halves(layout) * (half_steps(layout) / f) * mt * 4 +
             1023) / 1024 * 1024;
  return g;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ uint32_t ldmatrix_x1_trans(const void* p) {
  uint32_t r;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
      : "=r"(r)
      : "r"(smem_u32(p)));
  return r;
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// a - b on two pairs of T, rounded to T.
template <typename T>
__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b) {
  if constexpr (Elem<T>::kF16) {
    __half2 r = __hsub2(*reinterpret_cast<__half2*>(&a),
                        *reinterpret_cast<__half2*>(&b));
    return *reinterpret_cast<uint32_t*>(&r);
  } else {
    return bf16x2_sub(a, b);
  }
}

// kInt4: v holds bytes (row t, column 2g), (t, 2g + 1), (t + 4, 2g),
// (t + 4, 2g + 1); byte i is A register i. Its nibbles (k 2t + 8 [i / 2],
// + 1) become c + (n ^ 8) = c + 8 + n (c the magic number: 128 in bf16,
// 1024 in fp16), then n - z: c0 and c1 hold c + 8 + z of columns 2g and
// 2g + 1 twice in T (z = 0 without ZI).
template <typename T>
__device__ __forceinline__ void convert_int4(uint32_t v, uint32_t c0,
                                             uint32_t c1, uint32_t* a) {
  const uint32_t hi = v >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // byte 0: v's byte i (its low nibble at bits 0-3); byte 2: hi's byte
    // i (v's high nibble at bits 16-19)
    const uint32_t p = __byte_perm(v, hi, i | (i << 4) | ((4 + i) << 8) |
                                              ((4 + i) << 12));
    a[i] = sub2<T>((p & 0x000F000Fu) ^ (Elem<T>::kMagic | 0x00080008u),
                   (i & 1) ? c1 : c0);
  }
}

// kPacked and kUint4: v0 holds bytes (row 2t, column 2g), (2t, 2g + 1),
// (2t + 1, 2g), (2t + 1, 2g + 1) of the step's first 8 byte rows, v1 the
// same of the next 8; `shift` 0 takes the low nibbles, 4 the high ones.
// c + u (c the magic number), then u - z: c0, c1 hold c + z.
template <typename T>
__device__ __forceinline__ void convert_packed(uint32_t v0, uint32_t v1,
                                               int shift, uint32_t c0,
                                               uint32_t c1, uint32_t* a) {
  const uint32_t kc = Elem<T>::kMagic;  // 128.0 (bf16) or 1024.0 (fp16) twice
  a[0] = sub2<T>(((v0 >> shift) & 0x000F000Fu) | kc, c0);
  a[1] = sub2<T>(((v0 >> (8 + shift)) & 0x000F000Fu) | kc, c1);
  a[2] = sub2<T>(((v1 >> shift) & 0x000F000Fu) | kc, c0);
  a[3] = sub2<T>(((v1 >> (8 + shift)) & 0x000F000Fu) | kc, c1);
}

// kW8: the signed bytes at bits 0-7 and 16-23 of p (k and k + 1 of one
// column) as a pair of T, exact. In fp16 0x6400 | (b ^ 0x80) is 1024 + 128
// + b, exact (ulp 1 below 2048), and one fp16x2 subtraction of 1152 leaves
// b; bf16 cannot hold 128 + b (below). W8_CONVERT 2 writes 16 h to hi and
// l to lo, the high and low nibble of each byte (bf16 only, as
// W8_CONVERT 1: the timing variants).
template <typename T>
__device__ __forceinline__ uint32_t int8_pair(uint32_t p) {
  if constexpr (Elem<T>::kF16) {
    return sub2<T>(((p & 0x00FF00FFu) ^ 0x00800080u) | 0x64006400u,
                   0x64806480u);  // - (1024 + 128)
  }
#if W8_CONVERT == 1
  return bf16x2_sub((p & 0x007F007Fu) | 0x43004300u,
                    (p & 0x00800080u) | 0x43004300u);
#else
  const uint32_t u = p ^ 0x00800080u;  // b + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442));
  return pack_bf16(f0 - 8388736.f, f1 - 8388736.f);  // - (2^23 + 128)
#endif
}

__device__ __forceinline__ void nibble_pair(uint32_t p, uint32_t& hi,
                                            uint32_t& lo) {
  // 128 + (n ^ 8) = 136 + h for the signed high nibble h, then 16 h =
  // 16 (136 + h) - 2176, exact in one bf16x2 fma.
  uint32_t t = ((p >> 4) & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 r =
      __hfma2(*reinterpret_cast<__nv_bfloat162*>(&t),
              __float2bfloat162_rn(16.f), __float2bfloat162_rn(-2176.f));
  hi = *reinterpret_cast<const uint32_t*>(&r);
  lo = bf16x2_sub((p & 0x000F000Fu) | 0x43004300u, 0x43004300u);
}

// kW8 with v0, v1 as for convert_packed: a[0, 4) (and, W8_CONVERT 2, the
// second product's a[4, 8)).
template <typename T>
__device__ __forceinline__ void convert_w8(uint32_t v0, uint32_t v1,
                                           uint32_t* a) {
  const uint32_t p[4] = {v0, v0 >> 8, v1, v1 >> 8};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (W8_CONVERT == 2 && !Elem<T>::kF16)
      nibble_pair(p[i], a[i], a[4 + i]);
    else
      a[i] = int8_pair<T>(p[i]);
  }
}

// kFp8: the e4m3 bytes at bits 0-7 and 16-23 of p (k and k + 1 of one
// column) as a pair of T, exact for every finite byte.
template <typename T>
__device__ __forceinline__ uint32_t e4m3_pair(uint32_t p) {
  if constexpr (Elem<T>::kF16) {
    // The two bytes side by side (k in the low byte), then the hardware's
    // cvt.rn.f16x2.e4m3x2: one instruction, exact (e4m3 lies inside fp16,
    // subnormals too).
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)__byte_perm(p, 0u, 0x4420), __NV_E4M3);
    return (uint32_t)h.x | ((uint32_t)h.y << 16);
  }
  // sign to bit 15, exponent and mantissa to bits 7-10 and 4-6: the bf16
  // 2^-120 times the e4m3 value (a bf16 subnormal where the byte is one);
  // one product with 2^120 (0x7B80) restores it.
  uint32_t b = ((p & 0x00800080u) << 8) | ((p & 0x007F007Fu) << 4);
  const uint32_t k2p120 = 0x7B807B80u;
  __nv_bfloat162 r = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&b),
                             *reinterpret_cast<const __nv_bfloat162*>(&k2p120));
  return *reinterpret_cast<uint32_t*>(&r);
}

// kFp8 with v0, v1 as for convert_packed: a[0, 4).
template <typename T>
__device__ __forceinline__ void convert_fp8(uint32_t v0, uint32_t v1,
                                            uint32_t* a) {
  a[0] = e4m3_pair<T>(v0);
  a[1] = e4m3_pair<T>(v0 >> 8);
  a[2] = e4m3_pair<T>(v1);
  a[3] = e4m3_pair<T>(v1 >> 8);
}

// c + z in T, twice: exact where the caller took the zeros inside the
// product (an integer of at most 256 in bf16, 2048 in fp16).
template <typename T>
__device__ __forceinline__ uint32_t twice(float v) {
  return pack<T>(v, v);
}

// The k range of x that half h of a stage starting at byte row r0 covers.
template <int L>
__device__ __forceinline__ int half_k0(int r0, int h, int K) {
  return L == kInt4 ? 2 * r0 : L == kPacked ? h * (K / 2) + r0 : r0;
}

template <int L, int MT, int F, bool ZI, bool RS, typename T>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 1)
    w4_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap s_map,
                    const __grid_constant__ CUtensorMap z_map,
                    const __grid_constant__ CUtensorMap x_map,
                    T* __restrict__ out,
                    float* __restrict__ partial, int* __restrict__ counters,
                    const float* __restrict__ col_scales,
                    const float* __restrict__ row_scales, int M, int K,
                    int N, int group, int gs, int chunk_rows, int m_tiles,
                    int stages) {
  static_assert(!col_scaled(L) || (ZI && F == half_steps(L)),
                "kW8 and kFp8 have no zeros and fold once a stage");
  static_assert(!RS || L == kFp8, "a scale a row of x is kFp8's W8A8");
  constexpr int kHalves = halves(L);
  constexpr int kXBoxes = x_boxes(L);
  constexpr int kD = MT / 2;  // accumulator floats a thread
  constexpr int kSteps = half_steps(L);
  constexpr int kFolds = kSteps / F;
  constexpr int kA = 4 * step_products(L);  // A registers a step
  static_assert(kSteps % F == 0, "a fold takes whole steps");
  // Sums of x: one item is 16 rows of M over one fold's range.
  constexpr int kSumItems = kHalves * kFolds * (MT / 16);
  constexpr int kSumRounds = (kSumItems + 2) / 3;  // items a warp, at most
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: TMA, ldmatrix's
  // addresses and wgmma agree on it for boxes that start on such a
  // boundary (at the same offset in both blocks, which multicast needs).
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const StageGeo geo = stage_geo(L, MT, gs, F);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * geo.bytes);
  uint64_t* empty = full + stages;
  uint64_t* sums = empty + stages;
  int* last_flag = reinterpret_cast<int*>(sums + stages);
  const uint32_t rank = cluster_ctarank();
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kEmptyArrivals);
      mbar_init(&sums[s], kSumThreads);
    }
    mbar_fence_init();
  }
  cluster_sync();  // no block loads into or releases the other's ring early

  // Block (pair, M tile, rank): column tile 2 pair + rank, so that both
  // blocks of a cluster share the M tile and the K split (and with it x).
  const int pm = blockIdx.x / kCluster;
  const int mt_idx = pm % m_tiles, tile = (pm / m_tiles) * kCluster + rank;
  const int col0 = tile * kBN, m0 = mt_idx * MT;
  // A block past N (odd tile count) loads the last tile again, for its
  // partner's sake, and writes nothing.
  const int col_load = min(col0, (N - 1) / kBN * kBN);
  const int r_begin = blockIdx.y * chunk_rows;
  const int r_end = min(byte_rows(L, K), r_begin + chunk_rows);
  const int n_stages = (r_end - r_begin + kRows - 1) / kRows;

  if (threadIdx.x < 128) {
    regs_dealloc<56>();
    if (threadIdx.x < 32) {
      // ------------------------------------------------------ producer
      if (threadIdx.x == 0) {
        const uint32_t tx = kWBytes + 2 * kHalves * gs * kBN * 4 +
                            kXBoxes * MT * 128;
        int stage = 0;
        uint32_t phase = 0;
        for (int st = 0; st < n_stages; ++st) {
          const int r0 = r_begin + st * kRows;
          uint8_t* sb = ring + stage * geo.bytes;
          mbar_wait(&empty[stage], phase ^ 1);  // free in both blocks
          if (dropped(kDropLoads)) {
            mbar_arrive(&full[stage]);
          } else {
            mbar_arrive_expect_tx(&full[stage], tx);
            tma_load_2d(sb, &w_map, &full[stage], col_load, r0);
            if (!col_scaled(L)) {
#pragma unroll
              for (int h = 0; h < kHalves; ++h) {
                const int g0 = half_k0<L>(r0, h, K) / group;
                tma_load_2d(sb + geo.s_off + h * gs * kBN * 4, &s_map,
                            &full[stage], col_load, g0);
                tma_load_2d(sb + geo.z_off + h * gs * kBN * 4, &z_map,
                            &full[stage], col_load, g0);
              }
            }
            // x box b: kInt4's k [2 r0 + 64 b, + 64), kPacked's half b,
            // the byte layouts' only box.
#pragma unroll
            for (int b = 0; b < kXBoxes; ++b) {
              const int kx =
                  L == kInt4 ? 2 * r0 + 64 * b : half_k0<L>(r0, b, K);
              uint8_t* dst = sb + geo.x_off + b * MT * 128;
              if (dropped(kDropMulticast))
                tma_load_2d(dst, &x_map, &full[stage], kx, m0);
              else if (b == (int)rank)
                tma_load_2d_multicast(dst, &x_map, &full[stage], kx, m0,
                                      (1 << kCluster) - 1);
            }
          }
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
        // Stay until both blocks' consumers have released every stage:
        // they arrive on this block's barriers.
        for (int s = 0; s < stages; ++s) {
          mbar_wait(&empty[stage], phase ^ 1);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      __syncwarp();
    } else {
      // ---------------------------------------------------- sums of x
      const int xt = threadIdx.x - 32;
      int stage = 0;
      uint32_t phase = 0;
      for (int st = 0; st < n_stages; ++st) {
        const int r0 = r_begin + st * kRows;
        const int rows = min(kRows, r_end - r0);
        const uint8_t* sb = ring + stage * geo.bytes;
        float* xs = reinterpret_cast<float*>(ring + stage * geo.bytes +
                                             geo.xs_off);
        mbar_wait(&full[stage], phase);
        if (!ZI && !dropped(kDropSums)) {
          // Item (h, f, 16-row group) of warp xw: d = x rows [16 g16, + 16)
          // times ones over the fold's k16 steps (those before the last
          // real row: kPacked's last stage would run on into the high
          // half's x); each row of d then holds the row's sum of x. A
          // fragments by ldmatrix from the swizzled box (chunk c of row r
          // at c ^ (r % 8)).
          const int nk = L == kInt4 ? 2 * rows : rows;
          const uint32_t ones[2] = {Elem<T>::kOnes, Elem<T>::kOnes};
          const int xw = xt >> 5, lane = xt & 31;
          const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);
          const int lchunk = lane >> 4;
#pragma unroll 1
          for (int r = 0; r < kSumRounds; ++r) {
            const int it = xw + 3 * r;
            if (it >= kSumItems) break;
            const int hf = it / (MT / 16), g16 = it - hf * (MT / 16);
            const int h = hf / kFolds, f = hf - h * kFolds;
            const int m = 16 * g16 + lrow;
            float dsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int i = 0; i < F; ++i) {
              const int k16 = 16 * (F * f + i);
              if (k16 >= nk) break;
              const int kl = (L == kPacked ? 64 * h : 0) + k16;
              uint32_t a[4];
              ldmatrix_x4(a, sb + geo.x_off + (kl >> 6) * MT * 128 +
                                 m * 128 +
                                 (((((kl & 63) >> 3) + lchunk) ^ (m & 7))
                                  << 4));
              mma16816<T>(dsum, a, ones);
            }
            // Lane (g, t) holds row g's sum in dsum[0], row g + 8's in
            // dsum[2] (every column of d is the same).
            if ((lane & 3) == 0) {
              float* o = xs + hf * MT + 16 * g16 + (lane >> 2);
              o[0] = dsum[0];
              o[8] = dsum[2];
            }
          }
        }
        mbar_arrive(&sums[stage]);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  regs_alloc<224>();
  const int c = threadIdx.x / 128 - 1;  // columns [64 c, 64 c + 64)
  const int w = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q = 4 * c + w;  // the warp's 16-column chunk of the box
  // ldmatrix row addresses: kInt4's matrix row ri is byte row ri / 2 +
  // 4 (ri % 2) of the step's 8 (so .trans hands lane (g, t) rows t and
  // t + 4); the other layouts' matrix (lane / 8) % 2, row ri is byte row
  // 8 (lane / 8 % 2) + ri of the step's 16. Chunk q of row r sits at chunk
  // q ^ (r % 8).
  const int ri = lane & 7;
  int lane_off;
  if (L == kInt4) {
    const int r = (ri >> 1) + 4 * (ri & 1);
    lane_off = r * 128 + ((q ^ r) << 4);
  } else {
    const int r = 8 * ((lane >> 3) & 1) + ri;
    lane_off = r * 128 + ((q ^ ri) << 4);
  }
  const int n_loc = 64 * c + 16 * w + 2 * g;  // columns of A rows g, g + 8

  float acc[kD], d[kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) acc[i] = d[i] = 0.f;

  int stage = 0;
  uint32_t phase = 0;
  for (int st = 0; st < n_stages; ++st) {
    const int r0 = r_begin + st * kRows;
    const int rows = min(kRows, r_end - r0);
    const uint8_t* sb = ring + stage * geo.bytes;
    mbar_wait(&full[stage], phase);
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      const int ks = half_k0<L>(r0, h, K);
      // Step j's A fragment in a[j]; step j + 1 is converted while the
      // products before it run.
      uint32_t a[kSteps][kA];
#pragma unroll
      for (int f = 0; f < kFolds; ++f) {
        // The fold's group, as a row of the stage's scales (a fold past
        // the last real row adds zero: its q, d and sums are 0).
        float2 sv = make_float2(0.f, 0.f), zv = sv;
        uint32_t c0 = 0u, c1 = 0u;
        if (!col_scaled(L)) {
          const int row =
              h * gs + min((ks + 16 * F * f) / group - ks / group, gs - 1);
          sv = *reinterpret_cast<const float2*>(
              sb + geo.s_off + (row * kBN + n_loc) * 4);
          zv = *reinterpret_cast<const float2*>(
              sb + geo.z_off + (row * kBN + n_loc) * 4);
          const float base = Elem<T>::kMagicF + (L == kInt4 ? 8.f : 0.f);
          c0 = twice<T>(base + (ZI ? zv.x : 0.f));
          c1 = twice<T>(base + (ZI ? zv.y : 0.f));
        }
#pragma unroll
        for (int i = 0; i < F; ++i) {
          const int j = F * f + i;
          if (dropped(kDropConvert)) {
#pragma unroll
            for (int e = 0; e < kA; ++e) a[j][e] = 0u;
          } else if (L == kInt4) {
            convert_int4<T>(ldmatrix_x1_trans(sb + 1024 * j + lane_off), c0,
                            c1, a[j]);
          } else {
            uint32_t v0, v1;
            ldmatrix_x2_trans(v0, v1, sb + 2048 * j + lane_off);
            if (L == kW8)
              convert_w8<T>(v0, v1, a[j]);
            else if (L == kFp8)
              convert_fp8<T>(v0, v1, a[j]);
            else  // kPacked's nibble h; kUint4's low nibble (h == 0)
              convert_packed<T>(v0, v1, 4 * h, c0, c1, a[j]);
            if (L == kPacked && ZI) {
              // Past K/2 the zero-filled bytes would give -z against the
              // high half's x: those steps' A is zero (a mask, not a
              // branch, with products in flight). The byte layouts' x
              // past K is zero.
              const uint32_t keep = 0u - (uint32_t)(16 * j < rows);
#pragma unroll
              for (int e = 0; e < 4; ++e) a[j][e] &= keep;
            }
          }
          if (!dropped(kDropProducts)) {
            const int kl = (L == kPacked ? 64 * h : 0) + 16 * j;
            const uint64_t desc = wgmma_desc(
                sb + geo.x_off + (kl >> 6) * MT * 128 + (kl & 63) * 2, 16,
                1024);
            fence_regs<kA>(a[j]);
            fence_regs<kD>(d);
            wgmma_fence();
#pragma unroll
            for (int p = 0; p < kA / 4; ++p)
              wgmma_rs<MT, T>(d, a[j] + 4 * p, desc,
                           (col_scaled(L) || i > 0 || p > 0) ? 1 : 0);
          }
        }
        if (!dropped(kDropProducts)) {
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<kD>(d);
        }
        if (col_scaled(L)) {
          // no groups: d runs on over the split; scaled in the epilogue
        } else if (dropped(kDropFold)) {
#pragma unroll
          for (int i = 0; i < kD; ++i) acc[i] += d[i];
        } else if (ZI) {
          // acc[4 j + 2 h + i]: column n_loc + h.
#pragma unroll
          for (int j8 = 0; j8 < MT / 8; ++j8) {
            acc[4 * j8 + 0] += d[4 * j8 + 0] * sv.x;
            acc[4 * j8 + 1] += d[4 * j8 + 1] * sv.x;
            acc[4 * j8 + 2] += d[4 * j8 + 2] * sv.y;
            acc[4 * j8 + 3] += d[4 * j8 + 3] * sv.y;
          }
        } else {
          if (h == 0 && f == 0) mbar_wait(&sums[stage], phase);
          const float* xs = reinterpret_cast<const float*>(
                                sb + geo.xs_off) +
                            (h * kFolds + f) * MT + 2 * t;
#pragma unroll
          for (int j8 = 0; j8 < MT / 8; ++j8) {
            const float2 xv = *reinterpret_cast<const float2*>(xs + 8 * j8);
            acc[4 * j8 + 0] += (d[4 * j8 + 0] - xv.x * zv.x) * sv.x;
            acc[4 * j8 + 1] += (d[4 * j8 + 1] - xv.y * zv.x) * sv.x;
            acc[4 * j8 + 2] += (d[4 * j8 + 2] - xv.x * zv.y) * sv.y;
            acc[4 * j8 + 3] += (d[4 * j8 + 3] - xv.y * zv.y) * sv.y;
          }
        }
        fence_regs<kD>(d);
      }
    }
    // Every product reading this stage is done (each fold waits for its
    // own): release it in both blocks.
    __syncwarp();
    if (lane < kCluster) mbar_arrive_cluster(&empty[stage], lane);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // ------------------------------------------------------------- epilogue
  if (col_scaled(L)) {  // y = d s: columns n_loc, n_loc + 1 (N % 16 == 0)
    const int col = col0 + n_loc;
    const float2 sv =
        col < N ? __ldg(reinterpret_cast<const float2*>(col_scales + col))
                : make_float2(0.f, 0.f);
#pragma unroll
    for (int j8 = 0; j8 < MT / 8; ++j8) {
      if (RS) {  // (d rs[m]) s[n]: rows 8 j + 2 t and + 1 of the M tile
        const int m = m0 + 8 * j8 + 2 * t;
        const float r0 = m < M ? __ldg(row_scales + m) : 0.f;
        const float r1 = m + 1 < M ? __ldg(row_scales + m + 1) : 0.f;
        d[4 * j8 + 0] *= r0;
        d[4 * j8 + 1] *= r1;
        d[4 * j8 + 2] *= r0;
        d[4 * j8 + 3] *= r1;
      }
      acc[4 * j8 + 0] = d[4 * j8 + 0] * sv.x;
      acc[4 * j8 + 1] = d[4 * j8 + 1] * sv.x;
      acc[4 * j8 + 2] = d[4 * j8 + 2] * sv.y;
      acc[4 * j8 + 3] = d[4 * j8 + 3] * sv.y;
    }
  }
  if (dropped(kDropStores) ||
      (dropped(kDropPartials) && partial != nullptr)) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kD; ++i) sum += acc[i];
    if (sum == 1234.5f) *reinterpret_cast<uint32_t*>(out) = pack<T>(sum, sum);
    return;
  }
  if (col0 >= N) return;
  const int tid = threadIdx.x - 128;  // 0..255 over both consumers
  named_sync(1, 256);  // both consumers are done with the ring
  float* tile_s = reinterpret_cast<float*>(ring) + c * MT * kPitch;
  // acc[4 j + 2 h + i]: column n_loc + h, row 8 j + 2 t + i.
#pragma unroll
  for (int j8 = 0; j8 < MT / 8; ++j8)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(tile_s + (8 * j8 + 2 * t + i) * kPitch +
                                 n_loc - 64 * c) =
          make_float2(acc[4 * j8 + i], acc[4 * j8 + 2 + i]);
  named_sync(2 + c, 128);
  const int wid = threadIdx.x & 127;
  const int ncol0 = col0 + 64 * c, ncols = N - ncol0;
  if (partial == nullptr) {
    for (int it = wid; it < MT * 8; it += 128) {
      const int m = it >> 3, ch = it & 7, row = m0 + m;
      if (row >= M || 8 * ch >= ncols) continue;
      const float4 lo =
          *reinterpret_cast<const float4*>(tile_s + m * kPitch + 8 * ch);
      const float4 hi =
          *reinterpret_cast<const float4*>(tile_s + m * kPitch + 8 * ch + 4);
      *reinterpret_cast<uint4*>(out + (size_t)row * N + ncol0 + 8 * ch) =
          make_uint4(pack<T>(lo.x, lo.y), pack<T>(lo.z, lo.w),
                     pack<T>(hi.x, hi.y), pack<T>(hi.z, hi.w));
    }
    return;
  }
  for (int it = wid; it < MT * 16; it += 128) {
    const int m = it >> 4, ch = it & 15, row = m0 + m;
    if (row >= M || 4 * ch >= ncols) continue;
    *reinterpret_cast<float4*>(
        partial + ((size_t)blockIdx.y * M + row) * N + ncol0 + 4 * ch) =
        *reinterpret_cast<const float4*>(tile_s + m * kPitch + 4 * ch);
  }
  // The last block of this (column tile, M tile) to finish adds the
  // splits' sums in split order and writes y; it resets the counter for
  // the next launch.
  __threadfence();
  named_sync(1, 256);
  int* counter = counters + tile * m_tiles + mt_idx;
  if (tid == 0) *last_flag = atomicAdd(counter, 1) == (int)gridDim.y - 1;
  named_sync(1, 256);
  if (!*last_flag) return;
  __threadfence();
  for (int it = tid; it < MT * 16; it += 256) {
    const int m = it >> 4, ch = it & 15, row = m0 + m, col = col0 + 8 * ch;
    if (row >= M || col >= N) continue;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int sp = 0; sp < (int)gridDim.y; ++sp) {
      const float* p = partial + ((size_t)sp * M + row) * N + col;
      const float4 lo = __ldcg(reinterpret_cast<const float4*>(p));
      const float4 hi = __ldcg(reinterpret_cast<const float4*>(p + 4));
      v[0] += lo.x;
      v[1] += lo.y;
      v[2] += lo.z;
      v[3] += lo.w;
      v[4] += hi.x;
      v[5] += hi.y;
      v[6] += hi.z;
      v[7] += hi.w;
    }
    *reinterpret_cast<uint4*>(out + (size_t)row * N + col) =
        make_uint4(pack<T>(v[0], v[1]), pack<T>(v[2], v[3]),
                   pack<T>(v[4], v[5]), pack<T>(v[6], v[7]));
  }
  if (tid == 0) *counter = 0;
}

// Dynamic shared memory of a launch: the ring, its three barriers a stage,
// the last-block flag and up to 1024 bytes to align the ring.
inline int smem_bytes(int layout, int mt, int gs, int f, int stages) {
  return stages * stage_geo(layout, mt, gs, f).bytes + 3 * stages * 8 + 16 +
         1024;
}

// A launch's arguments past the template switches.
struct Launch {
  const CUtensorMap* maps;  // w, s, z
  const void* x;
  void* out;
  float* partial;
  int* counters;
  const float* col_scales;
  const float* row_scales;
  int M, K, N, group, gs, splits, chunk_rows, m_tiles, stages;
  cudaStream_t stream;
};

template <typename T, int L, int MT, int F, bool ZI, bool RS = false>
int launch(const Launch& a) {
  // x [M, K]: boxes of MT rows x 64 k (128 bytes, 128-byte swizzle); rows
  // past M and k past K read zeros.
  CUtensorMap x_map;
  const uint64_t dims[2] = {(uint64_t)a.K, (uint64_t)a.M};
  const uint64_t strides[1] = {(uint64_t)a.K * 2};
  const uint32_t box[2] = {64, MT};
  cudaError_t err = make_tma_map(&x_map, Elem<T>::kMap, a.x, 2, dims,
                                 strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  const int smem = smem_bytes(L, MT, a.gs, F, a.stages);
  if (a.stages * stage_geo(L, MT, a.gs, F).bytes < 2 * MT * kPitch * 4)
    return (int)cudaErrorInvalidValue;  // the epilogue's tiles must fit
  err = allow_smem<w4_wgmma_kernel<L, MT, F, ZI, RS, T>>(smem);
  if (err != cudaSuccess) return (int)err;
  const int pairs = ((a.N + kBN - 1) / kBN + kCluster - 1) / kCluster;
  const dim3 grid(pairs * a.m_tiles * kCluster, a.splits);
  w4_wgmma_kernel<L, MT, F, ZI, RS, T><<<grid, kThreads, smem, a.stream>>>(
      a.maps[0], a.maps[1], a.maps[2], x_map, static_cast<T*>(a.out),
      a.splits > 1 ? a.partial : nullptr,
      a.counters, a.col_scales, a.row_scales, a.M, a.K, a.N, a.group, a.gs,
      a.chunk_rows, a.m_tiles, a.stages);
  return (int)cudaGetLastError();
}

// F: k16 steps a fold (kInt4 2, 4 or 8; kPacked 1, 2 or 4; kUint4 2 or 4;
// kW8 and kFp8 4); zi: the zeros are integers, taken inside the product
// (always for kW8 and kFp8, which have none); kFp8 with row scales takes
// the RS instance.
template <typename T, int L, int MT>
int launch_f(int f, int zi, const Launch& a) {
#define W4_LAUNCH(F_)                             \
  return zi ? launch<T, L, MT, F_, true>(a)       \
            : launch<T, L, MT, F_, false>(a)
  if constexpr (L == kW8) {
    if (f == 4 && zi) return launch<T, L, MT, 4, true>(a);
  } else if constexpr (L == kFp8) {
    if (f == 4 && zi)
      return a.row_scales != nullptr ? launch<T, L, MT, 4, true, true>(a)
                                     : launch<T, L, MT, 4, true, false>(a);
  } else if constexpr (L == kInt4) {
    if (f == 2) W4_LAUNCH(2);
    if (f == 4) W4_LAUNCH(4);
    if (f == 8) W4_LAUNCH(8);
  } else {
    if constexpr (L == kPacked) {
      if (f == 1) W4_LAUNCH(1);
    }
    if (f == 2) W4_LAUNCH(2);
    if (f == 4) W4_LAUNCH(4);
  }
#undef W4_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename T, int L>
int launch_mt(int mt, int f, int zi, const Launch& a) {
  switch (mt) {
    case 16:
      return launch_f<T, L, 16>(f, zi, a);
    case 32:
      return launch_f<T, L, 32>(f, zi, a);
    case 64:
      return launch_f<T, L, 64>(f, zi, a);
    case 128:
      return launch_f<T, L, 128>(f, zi, a);
  }
  return (int)cudaErrorInvalidValue;
}

// The launch of x [M, K] and y [M, N] of T (16-byte aligned), `maps` from
// w4_weight_maps, the rest of the launch in p[14] (fixed per weight and M,
// so the caller keeps it): layout (0 int4, 1 packed, 2 uint4, 3 w8, 4
// fp8); mt, the rows of M a block (16, 32, 64 or 128); f, the k16 steps a
// fold (16 f divides the group, and K/2 for packed; 4 for w8 and fp8); M,
// K, N, the group (unread for w8 and fp8); gs, the groups a stage's half
// can touch (0 for w8 and fp8); splits and chunk_rows, the K splits of
// chunk_rows byte rows (a multiple of 64); m_tiles (m_tiles * mt >= M);
// stages, the ring's depth (at least 2); zi, 1 where every zero is an
// integer that keeps c + z and every q - z exact in T (c = 136 for int4,
// 128 for packed and uint4 in bf16; 1032 and 1024 in fp16), which takes
// the zero inside the product (1 for w8 and fp8); x's dtype code (bf16 1,
// fp16 2), which must be T's. K is a multiple of 32, N of 16, the group
// of 32. With splits > 1, partial is fp32 [splits, M, N] scratch and
// counters one int per (column tile, M tile) (rounded up to an even
// number of column tiles), zero before and after the launch. col_scales:
// w8's and fp8's fp32 scales [N] (16-byte aligned), else unread.
// row_scales: fp8's W8A8 scales of x's rows [M] (fp32), or null
// (weight-only; the other layouts take null).
template <typename T>
int launch_entry(const int* p, const void* maps, const void* x, void* out,
                 float* partial, int* counters, const float* col_scales,
                 const float* row_scales, void* stream) {
  const int layout = p[0], mt = p[1], f = p[2], M = p[3], K = p[4], N = p[5],
            group = p[6], gs = p[7], splits = p[8], chunk_rows = p[9],
            m_tiles = p[10], stages = p[11], zi = p[12], dtype = p[13];
  if (dtype != Elem<T>::kCode || layout < kInt4 || layout > kFp8 ||
      (row_scales != nullptr && layout != kFp8))
    return (int)cudaErrorInvalidValue;
  const int rows = byte_rows(layout, K);
  bool bad = M < 1 || K < 32 || K % 32 != 0 || N < 16 || N % 16 != 0 ||
             stages < 2 || splits < 1 || chunk_rows < kRows ||
             chunk_rows % kRows != 0 ||
             (long long)(splits - 1) * chunk_rows >= rows ||
             (long long)splits * chunk_rows < rows || m_tiles < 1 ||
             (long long)m_tiles * mt < M ||
             (splits > 1 && (partial == nullptr || counters == nullptr));
  if (col_scaled(layout))
    bad = bad || f != half_steps(layout) || !zi || gs != 0 ||
          col_scales == nullptr;
  else
    bad = bad || group < 32 || group % 32 != 0 || K % group != 0 ||
          gs < 1 || f < 1 || group % (16 * f) != 0 ||
          (layout == kPacked && (K / 2) % (16 * f) != 0);
  if (bad) return (int)cudaErrorInvalidValue;
  CUtensorMap m[3];
  memcpy(m, maps, sizeof(m));
  const Launch a{m, x, out, partial, counters, col_scales, row_scales, M, K,
                 N, group, gs, splits, chunk_rows, m_tiles, stages,
                 static_cast<cudaStream_t>(stream)};
  switch (layout) {
    case kInt4:
      return launch_mt<T, kInt4>(mt, f, zi, a);
    case kPacked:
      return launch_mt<T, kPacked>(mt, f, zi, a);
    case kUint4:
      return launch_mt<T, kUint4>(mt, f, zi, a);
    case kW8:
      return launch_mt<T, kW8>(mt, f, zi, a);
    default:
      return launch_mt<T, kFp8>(mt, f, zi, a);
  }
}

}  // namespace
