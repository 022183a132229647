// The MLA geometry of the ragged and window attention kernels on Hopper's
// warpgroup products (CUDA, sm_90a): bf16 or fp16 queries of any group on
// one KV head of head_dim 576.
//
// Replaces the MLA geometry of the TPU kernels `ragged_paged_attention` /
// `_rpa_kernel` (aphrodite_tpu/ops/ragged_paged_attention.py) and
// `window_decode_attention` / `_wd_kernel`
// (aphrodite_tpu/ops/window_decode_attention.py), which the JAX package's
// DeepSeek V2/V3 runs as MQA over one latent head (models/deepseek.py:
// K = [c_kv, k_pe], V = [c_kv, 0], 512 + 64 = 576 lanes; the JAX runner
// shrinks block_q for it, worker/runner.py:216-245). They compute what the
// other instances compute (csrc/ragged_paged_attention.cu,
// csrc/window_decode_attention.cu): causal attention with the optional soft
// cap (a template switch), sliding window and chunked local attention (a
// mask), fully masked rows 0. V is read as the cache holds it: the kernels
// assume neither its zero lanes nor its equality to K.
//
// One block shape serves both instances (mla_kernel<kCap, kWindow, T, KV>,
// T q's element type, bf16 or fp16, and KV the cache's, T or fp8): 64
// query rows (one wgmma M) against 32-key tiles of K and V.
// - Warp 0 (the producer warpgroup's; setmaxnreg 24) reads the block table
//   itself and loads each tile by TMA from one tensor map over the cache
//   layer, [P 2 kvh page, 576] rows, in boxes of 64 columns (128 bytes,
//   128-byte swizzle; 576 = 9 x 64) and min(page, 32) rows, so a tile on
//   16-token pages takes two boxes a chunk; the window's tail tiles come
//   from two more maps over [R kvh kw, 576]. Its lanes issue a tile's boxes
//   side by side after lane 0 has armed the mbarrier with their bytes; the
//   page ids are read before the producer waits for the stage.
// - A ring of two stages of a K and a V tile (36,864 bytes each) under
//   "full" and "empty" mbarriers, so the next tile's loads run under this
//   one's products. A box whose keys all lie at or past the tile's last
//   loadable key (the context's end, or an unwritten tail slot) is not
//   loaded; the rows past that key hold stale bytes (another page's, or
//   garbage), so each consumer zeroes them in its own columns of V before P
//   V (0 x Inf would be NaN) and the mask takes them out of S.
// - Three consumer warpgroups (setmaxnreg 160) own 192 columns of O each
//   (three whole 64-column atoms of the swizzle, 96 fp32 a thread: the 576
//   columns fit no fewer warpgroups' registers) and multiply P (T, from
//   registers: the S accumulator is the A fragment) by their columns of V
//   (MN-major B, one m64n192k16 a k16 step). S = Q K^T (m64n32k16, Q and K
//   K-major from shared memory):
//   ragged: each warpgroup takes the part over its own three chunks (12 of
//     the 36 products: three chains side by side, where one warpgroup would
//     wait on 36 in a row), writes it into its own chunks of the K tile it
//     has just read, and after one barrier adds the three parts in
//     warpgroup order: the same S, softmax and P in each, and no hand-off;
//   window: warpgroup 0 takes S and the softmax and hands P and the rescale
//     factors on through shared memory (two tiles deep): less work a tile,
//     where a block walks a few tiles from HBM (each instance timed with
//     both schemes on an H100: each kept the faster).
//   The rows of a warp's 16 live in that warp alone, so the softmax needs
//   no shared memory; O's rescale is skipped where no row of a warp moved
//   its maximum (alpha exactly 1).
// - Q (64 rows) is staged once by the consumers with cp.async into the
//   swizzled layout (rows past the block's, zeros); the ragged output goes
//   out through each warpgroup's own chunks of Q in whole 16-byte pieces.
// Shared memory: Q 73,728 bytes, the ring 147,456, the window's hand-off
// 8,704, twelve mbarriers and 1024 bytes to align the swizzle: 231,008
// bytes, one block an SM. Registers: 24 x 128 + 160 x 384 = 64,512 of
// 65,536.
//
// mla_ragged (B1's MLA instance): a block is a work item's rows (tokens x
// group, token-major) or a slice of 64 of them (grid.z: V3's 128 query
// heads on one KV head take two), writing out normalized T.
// mla_window (B2's MLA instance): the window's split-KV scheme
// (csrc/window_decode_attention.cu: the host's 64-key plan tiles, each
// walked as two of 32, the page / tail split, the cascade start at
// shared_len), a block per (request, 64-row tile of the group, split); at
// group 16 the wgmma's other 48 rows are idle (zero queries). Each block
// writes its split's unnormalized state and mla_merge_kernel adds the init
// state (the cascade's) and the splits in a fixed order
// (csrc/split_decode.cuh merge_row): no float atomics, two launches are
// bit-equal. (A merge by the last block of a row tile to finish, on its
// 384 threads, was slower than this second launch.) The host plans the
// splits for one block an SM
// (ops/window_decode_attention.py window_split_plan): at most one wave.
//
// Bound. DeepSeek-V2-Lite's wave (32 x 512 tokens, 16 heads) moves ~0.64 GB
// (q and out 302 MB each, K/V 38 MB): >= 0.19 ms; its products are 155
// GFLOP, >= 0.16 ms at the bf16 peak. A window sub-step at R = 32 reads ~40
// MB of K/V: >= 0.012 ms. Neither instance reaches its bound (PERF.md):
// with the loads under the ring, what is left is each 32-key tile's fixed
// work (the barrier and the parts of S, or the hand-off; the softmax; O's
// rescale) and each block's Q load and output, which no other work hides
// (a ragged block walks ~9 tiles at 4-token items).
//
// The fp8 cache (e4m3fn or e5m2; the template's KV): the TPU kernels upcast
// an fp8 K/V tile to q's dtype before both products
// (ragged_paged_attention.py:194-196, window_decode_attention.py:162-164),
// and wgmma has no bf16 x fp8 form, so the bytes become T (bf16 here) in
// shared memory, exactly (attn::fp8x2_to), in the same 147,456 bytes:
// - the ring holds the staged bytes, two stages of a K and a V tile of
//   18,432 bytes each, loaded by TMA in boxes of 192 columns (a consumer
//   warpgroup's three chunks; 192 bytes a row, no swizzle) from one-byte
//   maps; its loads stay two tiles ahead;
// - one bf16 K and one bf16 V tile in the layout above, into which each
//   consumer warpgroup converts its own third (two rows x four 16-byte
//   pieces of one chunk to every eight threads: no bank conflicts either
//   side), each third under a product: V under S's, the next tile's K
//   under P V's. Ragged: each warpgroup reads only its own chunks of K
//   (its part of S) and of V (its columns of O); its part of S goes into
//   its own thirds of the tile's stage, converted by then, and every
//   warp gives the stage back once the parts are added. Window: warpgroup
//   0 takes S over all nine chunks, so it waits on a named barrier to
//   which the other two arrive once they have converted their thirds of
//   K (they do so as soon as P arrives: S is done with the K tile then);
//   a stage's K and V are given back as they are converted. V's rows past
//   the last loadable key are written as zeros; K's are masked.
//   What holds these instances (PERF.md, an H100 at V2-Lite's shapes:
//   ragged 1.39x, window 1.28x the bf16 instances' device time) is the
//   conversion's shared-memory traffic, each tile's bytes read and its
//   bf16 written once more beside the products' reads: not its
//   arithmetic (without it, 1.23x) nor its order (converting each third
//   just before its product, warpgroup 0 all of the window's K: the same
//   ragged time, 1.38x in the window).
// - Beside e5m2 the window's tails are bf16 (the JAX runner's rule): the
//   consumers copy a tail tile's rows, each warpgroup its third, straight
//   into the bf16 tiles with cp.async (rows past the step zero-filled),
//   outside the ring; beside e4m3 the tails are fp8 and ride the ring like
//   the pages.
// The bf16 instances keep their code (the switch is a template type), and
// the fp8 ones compute what those compute on the cache upcast to bf16, bit
// for bit.
//
// fp16 queries (T = __half; the TPU kernels take q in any dtype, compute S
// in fp32 and round P to V's dtype before P V,
// ragged_paged_attention.py:229, window_decode_attention.py:128): the same
// code with wgmma's f32.f16.f16 forms of both products (each asm written
// once, the type a string), P rounded to fp16 before P V (the window's
// hand-off carries the fp16 P), fp16 tensor maps over an fp16 cache and
// tails, an fp8 cache's bytes converted into fp16 tiles (e4m3 and e5m2 are
// exact in fp16; attn::fp8x2_to<KV, __half>), the bf16 tails beside e5m2
// converted to fp16 in shared memory by the threads that copied them
// (attn::bf16x2_to_f16x2), and the output rounded once to fp16. The bf16
// instances are built in csrc/mla_attention.cu, the fp16 ones in
// csrc/mla_attention_f16.cu (entries mla_ragged_f16_launch and
// mla_window_f16_launch), each library with its own table of tensor maps;
// each entry checks q's dtype code against its T.
//
// The ragged options (mla_kernel<kCap, false, T, KV, kOpts = true>): the TPU
// kernel has one body for every head_dim, so at 576 too it masks image
// spans (ragged_paged_attention.py:173-184) and adds ALiBi before the soft
// cap (:201-216). The option instances read the slopes and the spans
// through pointers in Args, either null (uniform branches); the instances
// without them keep their code as it was (kOpts false: DeepSeek's paths).
// - Spans: a block scans keys up to the end of the spans that meet its
//   item (attn::span_kv_limit, at most seq_len), so n_tiles, the
//   producer's box skipping and V's zeroed rows follow kv_limit as they did
//   the causal limit; each consumer thread keeps its two rows' span
//   [s_lo, s_hi) (attn::row_span), and the mask is (causal OR span) AND
//   key < kv_limit, then the window and the chunk. The whole-tile test is
//   kept: spans only add keys past a row.
// - ALiBi: each thread reads its two rows' slopes once (query head h *
//   group + (row_lo + row) % group); S is scaled, the slope times (key -
//   q_pos) added, then capped, and the exponent's factor is log2(e) alone
//   (the instances without options fold the scale into it).
// They are built in csrc/mla_opts.cu (bf16) and csrc/mla_opts_f16.cu
// (fp16), on the three caches, beside the other instances. The window's
// JAX kernel has neither option: its MLA instance has none.
#pragma once

#include <string.h>

#include <algorithm>
#include <type_traits>

#include "hopper_common.cuh"
#include "split_decode.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;
using mma::allow_smem;
using mma::cp_async16;
using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::fast_exp2;

constexpr int kHD = 576;
constexpr int kChunks = kHD / 64;               // 128-byte column chunks
constexpr int kRows = 64;                       // query rows a block
constexpr int kKeys = 32;                       // keys a K or V tile
constexpr int kStages = 2;                      // tiles of K and V in flight
constexpr int kQChunk = kRows * 128;            // a chunk of Q's 64 rows
constexpr int kQBytes = kChunks * kQChunk;      // 73,728
constexpr int kKVChunk = kKeys * 128;           // a chunk of a tile's keys
constexpr int kKVBytes = kChunks * kKVChunk;    // 36,864: K or V
constexpr int kConsumers = 3;                   // warpgroups of 3 chunks
// An fp8 cache's staged tile: a third (192 columns, one TMA box wide) of
// its 32 rows after another, 192 bytes a row.
constexpr int kThirdCols = kHD / kConsumers;    // 192
constexpr int kKV8Third = kKeys * kThirdCols;   // 6,144
constexpr int kKV8Bytes = kConsumers * kKV8Third;  // 18,432: K or V
static_assert(kStages * 2 * kKV8Bytes + 2 * kKVBytes ==
                  kStages * 2 * kKVBytes,
              "the fp8 ring and the bf16 tiles take the bf16 ring's bytes");
constexpr int kThreads = 128 * (1 + kConsumers);  // with the producer
constexpr int kConsumerWarps = 4 * kConsumers;  // arrive on "empty"
constexpr int kBars = 4 * kStages;              // K, V x full, empty
constexpr int kExchange = 2 * 2 * 128 * 16 + 2 * kRows * 4;  // Handoff
// Q, the ring (or the fp8 ring and the two bf16 tiles), the window's
// hand-off of P, the mbarriers (the ring's, P full and P empty twice) and
// 1024 bytes to align the swizzle; mirrored in Python.
constexpr int kSmem =
    kQBytes + 2 * kStages * kKVBytes + kExchange + (kBars + 4) * 8 + 1024;
constexpr int kPlanKeys = 64;  // keys a tile of the window's host plan
constexpr float kLog2e = 1.4426950408889634f;

// d[0, 16) (+)= A (64 x 16, K-major) * B (16 x 32, K-major), both of q's
// element type T (bf16 or __half) from shared memory through descriptors;
// scale_d == 0 ignores d. Each product's asm is written once
// (MLA_WGMMA_SS_N32, MLA_WGMMA_RS_MN192) with the operand type a string, as
// hopper_common.cuh's HOPPER_WGMMA_RS_N.
#define MLA_WGMMA_SS_N32(TY)                                              \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %18, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"        \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15"                              \
      "}, %16, %17, p, 1, 1, 0, 0;\n"                                     \
      "}\n"                                                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
        "+f"(d[15])                                                       \
      : "l"(da), "l"(db), "r"(scale_d));

template <typename T>
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    MLA_WGMMA_SS_N32("f16");
  } else {
    MLA_WGMMA_SS_N32("bf16");
  }
}

// d[0, 96) += A (64 x 16, this thread's fragment, as wgmma_rs) * B
// (16 x 192, MN-major, read through db), of T.
#define MLA_WGMMA_RS_MN192(TY)                                            \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %101, 0;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " {"       \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                             \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                           \
      "%24, %25, %26, %27, %28, %29, %30, %31,"                           \
      "%32, %33, %34, %35, %36, %37, %38, %39,"                           \
      "%40, %41, %42, %43, %44, %45, %46, %47,"                           \
      "%48, %49, %50, %51, %52, %53, %54, %55,"                           \
      "%56, %57, %58, %59, %60, %61, %62, %63,"                           \
      "%64, %65, %66, %67, %68, %69, %70, %71,"                           \
      "%72, %73, %74, %75, %76, %77, %78, %79,"                           \
      "%80, %81, %82, %83, %84, %85, %86, %87,"                           \
      "%88, %89, %90, %91, %92, %93, %94, %95"                            \
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n"                      \
      "}\n"                                                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),  \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),  \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),  \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),  \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),  \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),  \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),  \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),  \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),  \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),  \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),  \
        "+f"(d[95])                                                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));

template <typename T>
__device__ __forceinline__ void wgmma_rs_mn192(float* d, const uint32_t* a,
                                               uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) {
    MLA_WGMMA_RS_MN192("f16");
  } else {
    MLA_WGMMA_RS_MN192("bf16");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// mbar_wait that traps where a phase never completes (a fault in the
// ring's bookkeeping would otherwise hang the card): ~2^26 polls, seconds.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

// K-major operand (Q, or K as B of S): chunk c of a tile whose chunks are
// `chunk` bytes apart, k16 step k 32 bytes in.
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int chunk,
                                           int c, int k) {
  return wgmma_desc(tile + c * chunk + 32 * k, 16, 1024);
}

// V as the MN-major B of P V: k16 step ks (keys 16 ks..) from chunk c on,
// the next 64 columns one chunk on.
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile, int c,
                                            int ks) {
  return wgmma_desc(tile + c * kKVChunk + 2048 * ks, kKVChunk, 1024);
}

// Everything the launch passes besides the tensor maps.
struct Args {
  const void* q;                        // of T
  void* out;                            // ragged, of T
  float *part_acc, *part_m, *part_l;    // window
  const int *item_req, *item_qstart, *item_qlen, *item_pos, *seq_lens;
  const int* paged_lens;                // window
  const bf16 *tail_k, *tail_v;          // window: bf16 tails beside e5m2
  const int* block_tables;
  int max_pages, nq, kvh, page_size, box_rows, kw, step;
  float scale;
  int sliding_window, chunk_attn;
  float soft_cap;
  int shared_len, tiles_per_split;
  // ragged, kOpts: ALiBi's [nq] fp32 slopes and the image spans [R,
  // num_spans, 2], either null
  const float* alibi;
  const int* spans;
  int num_spans;
};

// A block's query rows and key tiles.
struct Block {
  int h, group, rows;  // rows: the block's query rows (<= 64; 0: none)
  int req;             // the request
  const int* bt;       // its block table
  // ragged: the item and its slice
  int qstart, qlen, pos0, row_lo, kv_limit, t_lo;
  // window: the split's plan tiles from ta on, past the row tile g0
  int plen, q_pos, lo, t0, n_paged, ta, g0;
  int n_tiles;  // 32-key tiles to walk (the window: two a plan tile)
};

template <bool kWindow, bool kOpts = false>
__device__ __forceinline__ Block block_of(const Args& a) {
  Block b;
  b.group = a.nq / a.kvh;
  if constexpr (!kWindow) {
    const int item = blockIdx.x;
    b.h = blockIdx.y;
    b.req = a.item_req[item];
    b.qstart = a.item_qstart[item];
    b.qlen = a.item_qlen[item];
    b.pos0 = a.item_pos[item];
    b.row_lo = blockIdx.z * kRows;
    b.rows = min(kRows, b.qlen * b.group - b.row_lo);
    // With image spans the keys of every span that meets the item's
    // positions, below seq_len (attn::span_kv_limit, as the tensor-core
    // instance scans them); n_tiles follows.
    b.kv_limit =
        kOpts && a.spans != nullptr
            ? attn::span_kv_limit(a.spans + (size_t)b.req * a.num_spans * 2,
                                  a.num_spans, b.pos0, b.qlen,
                                  a.seq_lens[b.req])
            : min(b.pos0 + b.qlen, a.seq_lens[b.req]);
    b.t_lo = attn::first_visible(b.pos0 + b.row_lo / b.group,
                                 a.sliding_window, a.chunk_attn) /
             kKeys;
    b.n_tiles = b.rows > 0 && b.kv_limit > 0
                    ? max((b.kv_limit - 1) / kKeys - b.t_lo + 1, 0)
                    : 0;
  } else {
    // The request's 64-key plan tiles (window_decode_attention.cu
    // request_tiles): page tiles from the one holding its first visible
    // position lo (>= shared_len), then tail tiles.
    const int row_tiles = (b.group + kRows - 1) / kRows;
    b.req = blockIdx.x;
    b.h = blockIdx.y / row_tiles;
    b.g0 = (blockIdx.y - b.h * row_tiles) * kRows;
    b.rows = min(kRows, b.group - b.g0);
    b.plen = a.paged_lens[b.req];
    b.q_pos = b.plen + a.step;
    const int lo =
        attn::first_visible(b.q_pos, a.sliding_window, a.chunk_attn);
    b.lo = min(max(lo, a.shared_len), b.plen);
    b.t0 = b.lo / kPlanKeys;
    b.n_paged = (b.plen + kPlanKeys - 1) / kPlanKeys - b.t0;
    const int n = b.n_paged + (a.step + kPlanKeys) / kPlanKeys;
    b.ta = blockIdx.z * a.tiles_per_split;
    b.n_tiles = 2 * split::my_tiles(n, b.ta, a.tiles_per_split, blockIdx.z,
                                    gridDim.z);
  }
  b.bt = a.block_tables + (size_t)b.req * a.max_pages;
  return b;
}

// Tile i of a block: page positions from kv0 or tail slots from kv0, of
// which the first n_valid may be read (the rest lie past the context or
// the written tail; a window tile with none is skipped by both roles).
struct Tile {
  bool paged;
  int kv0, n_valid;
};

template <bool kWindow>
__device__ __forceinline__ Tile tile_of(const Block& b, const Args& a,
                                        int i) {
  Tile t;
  if constexpr (!kWindow) {
    t.paged = true;
    t.kv0 = (b.t_lo + i) * kKeys;
    t.n_valid = min(kKeys, b.kv_limit - t.kv0);
  } else {
    const int u = b.ta + (i >> 1), half = (i & 1) * kKeys;
    t.paged = u < b.n_paged;
    if (t.paged) {
      t.kv0 = (b.t0 + u) * kPlanKeys + half;
      t.n_valid = min(kKeys, b.plen - t.kv0);
    } else {
      t.kv0 = (u - b.n_paged) * kPlanKeys + half;
      t.n_valid = min(kKeys, a.step + 1 - t.kv0);
    }
  }
  return t;
}

// The cache's element type KV: bf16, or an fp8 cache's (staged bytes).
// Whether the window's tails are bf16 beside an fp8 cache (e5m2): their
// tiles skip the ring.
template <typename KV>
constexpr bool kBf16Tails =
    attn::is_fp8<KV> && std::is_same<attn::tail_t<KV>, bf16>::value;

// Whether tile t goes through the ring (all but bf16 tails beside fp8).
template <typename KV>
__device__ __forceinline__ bool in_ring(const Tile& t) {
  return !kBf16Tails<KV> || t.paged;
}

// The producer warp: K and V of every tile by TMA into the ring, lane by
// lane.
template <bool kWindow, typename KV>
__device__ __forceinline__ void produce(const Args& a, const Block& b,
                        const CUtensorMap* cache, const CUtensorMap* tail_k,
                        const CUtensorMap* tail_v, uint8_t* kv_s,
                        uint64_t* bars) {
  constexpr bool kFp8 = attn::is_fp8<KV>;
  // A box's pieces across a tile's columns: nine 64-column chunks (bf16),
  // or three 192-column thirds (fp8).
  constexpr int kPieces = kFp8 ? kConsumers : kChunks;
  constexpr int kTileBytes = kFp8 ? kKV8Bytes : kKVBytes;
  const int lane = threadIdx.x & 31;
  int n = 0;  // tiles through the ring
  for (int i = 0; i < b.n_tiles; ++i) {
    const Tile t = tile_of<kWindow>(b, a, i);
    if (t.n_valid <= 0 || !in_ring<KV>(t)) continue;
    // Boxes of `box` rows: page ones (several a tile on 8- or 16-token
    // pages), or one of the tail's; lane item e = lane + 32 k is box e /
    // kPieces, piece e % kPieces. Its row in the map is read before the
    // stage is free.
    const int box = t.paged ? a.box_rows : min(kKeys, a.kw);
    const int n_items =
        (t.paged ? (t.n_valid + box - 1) / box : 1) * kPieces;
    int row[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int e = lane + 32 * k;
      row[k] = 0;
      if (e < n_items) {
        const int key = t.kv0 + (e / kPieces) * box;
        if (t.paged) {
          const int pg = key / a.page_size;
          row[k] = (b.bt[pg] * 2 * a.kvh + b.h) * a.page_size + key -
                   pg * a.page_size;
        } else {
          row[k] = (b.req * a.kvh + b.h) * a.kw + key;
        }
      }
    }
    const int st = n % kStages;
    uint8_t* k_s = kv_s + st * 2 * kTileBytes;
    uint64_t* bar = bars + 4 * st;  // K full, K empty, V full, V empty
    const uint32_t bytes =
        (uint32_t)(n_items * box * (kFp8 ? kThirdCols : 128));
    const uint32_t parity = ((n / kStages) & 1) ^ 1;
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      wait_phase(&bar[2 * kv + 1], parity);  // the stage's K (V) is free
      if (lane == 0) mbar_arrive_expect_tx(&bar[2 * kv], bytes);
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int e = lane + 32 * k;
        if (e < n_items) {
          const int c = e % kPieces, bx = e / kPieces;
          // bf16: chunk c's rows of the box (128 bytes each, swizzled);
          // fp8: third c's rows (192 bytes each).
          uint8_t* dst = k_s + kv * kTileBytes +
                         (kFp8 ? c * kKV8Third + bx * box * kThirdCols
                               : c * kKVChunk + bx * box * 128);
          tma_load_2d(dst,
                      t.paged ? cache : (kv ? tail_v : tail_k), &bar[2 * kv],
                      (kFp8 ? kThirdCols : 64) * c,
                      t.paged && kv ? row[k] + a.kvh * a.page_size : row[k]);
        }
      }
    }
    ++n;
  }
}

// fp8 -> bf16 of third w (chunks 3w..3w+2, 192 columns) of a staged tile
// (src: the stage's K or V, thirds of 32 rows of 192 bytes) into the bf16
// tile dst, in its swizzled layout, by a warpgroup's thread tid. Rows
// [0, n) are converted; rows [n, 32) are zeroed where kZero (V: 0 x Inf
// would be NaN) and left as they are otherwise (K: the mask takes them).
// Item e: 16-byte piece q4 of chunk cc in row 2 rp + rb, so that eight
// threads read 2 x 64 staged bytes in distinct banks and write 8 distinct
// 16-byte slots of the swizzle.
template <typename KV, bool kZero, typename T>
__device__ __forceinline__ void convert_third(const uint8_t* src,
                                              uint8_t* dst, int w, int n,
                                              int tid) {
  const int end = kZero ? kKeys * 12 : ((n + 1) >> 1) * 24;
  for (int e = tid; e < end; e += 128) {
    const int q4 = e & 3, rb = (e >> 2) & 1, rest = e >> 3;
    const int cc = rest % 3, row = 2 * (rest / 3) + rb;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (row < n) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          src + w * kKV8Third + row * kThirdCols + (4 * cc + q4) * 16);
      lo = make_uint4(attn::fp8x2_to<KV, T>(v.x),
                      attn::fp8x2_to<KV, T>(v.x >> 16),
                      attn::fp8x2_to<KV, T>(v.y),
                      attn::fp8x2_to<KV, T>(v.y >> 16));
      hi = make_uint4(attn::fp8x2_to<KV, T>(v.z),
                      attn::fp8x2_to<KV, T>(v.z >> 16),
                      attn::fp8x2_to<KV, T>(v.w),
                      attn::fp8x2_to<KV, T>(v.w >> 16));
    } else if (!kZero) {
      continue;
    }
    uint8_t* d = dst + (3 * w + cc) * kKVChunk + row * 128;
    const int sw = row & 7, p = 2 * q4;
    *reinterpret_cast<uint4*>(d + ((p ^ sw) << 4)) = lo;
    *reinterpret_cast<uint4*>(d + (((p + 1) ^ sw) << 4)) = hi;
  }
}

// Third w of a bf16 tail tile's rows (beside e5m2: tail slots kv0.. of
// the block's request and head) straight into chunks 3w..3w+2 of the bf16
// tile dst by cp.async, rows [n, 32) zero-filled, by a warpgroup's thread
// tid; waited for by each thread.
template <typename T>
__device__ __forceinline__ void copy_tail(const bf16* tail, const Block& b,
                                          const Args& a, int kv0, int n,
                                          uint8_t* dst, int w, int tid) {
  const bf16* base = tail + ((size_t)(b.req * a.kvh + b.h) * a.kw + kv0) *
                                kHD;
  for (int e = tid; e < kKeys * 24; e += 128) {
    const int row = e / 24, rem = e - row * 24;
    const int cc = 3 * w + (rem >> 3), p = rem & 7;
    const bool ok = row < n;
    cp_async16(dst + cc * kKVChunk + row * 128 + ((p ^ (row & 7)) << 4),
               ok ? base + (size_t)row * kHD + cc * 64 + p * 8 : tail, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  if constexpr (std::is_same<T, __half>::value) {
    // fp16 queries: each thread converts the pieces it copied, in place
    // (attn::bf16x2_to_f16x2, as the other window instances convert their
    // bf16 tails; the zero-filled rows are zero in both types).
    for (int e = tid; e < n * 24; e += 128) {
      const int row = e / 24, rem = e - row * 24;
      const int cc = 3 * w + (rem >> 3), p = rem & 7;
      uint4* d = reinterpret_cast<uint4*>(dst + cc * kKVChunk + row * 128 +
                                          ((p ^ (row & 7)) << 4));
      uint4 v = *d;
      v.x = attn::bf16x2_to_f16x2(v.x);
      v.y = attn::bf16x2_to_f16x2(v.y);
      v.z = attn::bf16x2_to_f16x2(v.z);
      v.w = attn::bf16x2_to_f16x2(v.w);
      *d = v;
    }
  }
}

// The window's hand-off of P from consumer warpgroup 0 to the other two
// (shared memory past the ring), two tiles deep: P (bf16, thread t's A
// fragments of both k16 steps at [ks][t]) and the rows' rescale factors.
struct Handoff {
  uint4 p[2][2][128];
  float alpha[2][kRows];
};
static_assert(sizeof(Handoff) == kExchange, "the hand-off's bytes");

// A consumer thread's place: warpgroup c of the three (O's columns 192 c..
// 192 c + 191, chunks 3c..3c+2), its rows r0 and r0 + 8 of the block, and
// for the ragged instance their positions (rows past the block's take the
// last token's; never stored) and the warp's lowest and highest.
struct Lane {
  int c, tid, warp, lane, tq, r0;
  int qp[2], w_lo, w_hi;
  // kOpts: the keys [s_lo, s_hi) each row sees through its spans (empty
  // without), and its ALiBi slope (0 without)
  int s_lo[2], s_hi[2];
  float sl[2];
};

// The tile's logits (s[4 j + 2 h + i]: row r0 + 8 h, key kv0 + 8 j + 2 tq +
// i): the soft cap, the mask, then the online softmax of the rows (their
// values live in the four lanes of a quad). s becomes P in fp32, m and l
// move on, alpha rescales O; alpha is 1 exactly where a row's maximum
// held. The option instances (kOpts, ragged) scale s first, add ALiBi's
// slope * (key - q_pos) where slopes are given, then cap, as the TPU kernel
// orders them (ragged_paged_attention.py:201-216): m is then in the scaled
// logit's units and the exponent's factor is log2(e) alone. A key past a
// row is visible where both lie in one span of the row's request
// (ln.s_lo, ln.s_hi), below kv_limit, before the window and the chunk
// (:173-189); spans only add keys past a row, so a tile at or below every
// row of the warp (`full`) stays whole.
template <bool kCap, bool kWindow, bool kOpts = false>
__device__ __forceinline__ void softmax_tile(float* s, const Tile& t,
                                             const Block& b, const Args& a,
                                             const Lane& ln, float* m,
                                             float* l, float* alpha) {
  const int sw = a.sliding_window, ch = a.chunk_attn;
  const float mult = kOpts ? kLog2e : (kCap ? 1.f : a.scale) * kLog2e;
  if constexpr (kOpts) {
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] *= a.scale;
    if (a.alibi != nullptr) {  // block-uniform
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            s[4 * j + 2 * hf + i] = fmaf(
                ln.sl[hf],
                (float)(t.kv0 + 8 * j + 2 * ln.tq + i - ln.qp[hf]),
                s[4 * j + 2 * hf + i]);
    }
    if constexpr (kCap) {
      const float inv_cap = 1.f / a.soft_cap;
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = a.soft_cap * tanhf(s[i] * inv_cap);
    }
  } else if constexpr (kCap) {
    const float cap_scale = a.scale / a.soft_cap;
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = a.soft_cap * tanhf(s[i] * cap_scale);
  }
  // Tiles wholly visible to the warp's rows skip the mask.
  bool full = t.n_valid == kKeys;
  if constexpr (!kWindow)
    full = full && t.kv0 + kKeys - 1 <= ln.w_lo &&
           (sw <= 0 || t.kv0 > ln.w_hi - sw) &&
           (ch <= 0 || (t.kv0 / ch == (t.kv0 + kKeys - 1) / ch &&
                        t.kv0 / ch == ln.w_lo / ch &&
                        ln.w_lo / ch == ln.w_hi / ch));
  else
    full = full && (t.paged ? t.kv0 >= b.lo && t.kv0 + kKeys <= b.plen &&
                                  attn::local_ok(t.kv0, b.q_pos, sw, ch)
                            : t.kv0 + kKeys - 1 <= a.step &&
                                  attn::local_ok(b.plen + t.kv0, b.q_pos, sw,
                                                 ch));
  if (!full) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = t.kv0 + 8 * j + 2 * ln.tq + i;
        if constexpr (!kWindow) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            bool vis = key <= ln.qp[hf];
            if constexpr (kOpts)
              vis = vis || (key >= ln.s_lo[hf] && key < ln.s_hi[hf]);
            if (key >= b.kv_limit || !vis ||
                !attn::local_ok(key, ln.qp[hf], sw, ch))
              s[4 * j + 2 * hf + i] = -INFINITY;
          }
        } else {
          const bool vis =
              t.paged ? key >= b.lo && key < b.plen &&
                            attn::local_ok(key, b.q_pos, sw, ch)
                      : key <= a.step &&
                            attn::local_ok(b.plen + key, b.q_pos, sw, ch);
          if (!vis) s[4 * j + i] = s[4 * j + 2 + i] = -INFINITY;
        }
      }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float v = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v = fmaxf(v, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float mn = fmaxf(m[hf], v);
    // A row with no visible key yet keeps m = -inf: p = 0.
    const float base = mn == -INFINITY ? 0.f : mn * mult;
    alpha[hf] = mn == m[hf] ? 1.f : fast_exp2(m[hf] * mult - base);
    m[hf] = mn;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float& p = s[4 * j + 2 * hf + i];
        p = fast_exp2(fmaf(p, mult, -base));
        sum += p;
      }
    l[hf] = l[hf] * alpha[hf] + sum;
  }
}

// P (fp32, as softmax_tile leaves it) as the A fragments of P V's two k16
// steps, rounded to T.
template <typename T>
__device__ __forceinline__ void pack_p(const float* s, uint32_t (*pa)[4]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    pa[ks][0] = mma::pack<T>(s[8 * ks + 0], s[8 * ks + 1]);
    pa[ks][1] = mma::pack<T>(s[8 * ks + 2], s[8 * ks + 3]);
    pa[ks][2] = mma::pack<T>(s[8 * ks + 4], s[8 * ks + 5]);
    pa[ks][3] = mma::pack<T>(s[8 * ks + 6], s[8 * ks + 7]);
  }
}

// S = Q K^T over chunks c0..c0 + kN - 1 (all nine, or a warpgroup's
// three), into s: started (s_begin, the caller waits with s_wait) or
// waited for (s_products).
template <int kN, typename T>
__device__ __forceinline__ void s_begin(float* s, const uint8_t* q_s,
                                        const uint8_t* k_s, int c0) {
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.f;
  fence_regs<16>(s);
  wgmma_fence();
  // A k16 step or a chunk moves only the start address field (16-byte
  // units) of the first descriptor.
  const uint64_t dq = kmajor(q_s, kQChunk, c0, 0);
  const uint64_t dk = kmajor(k_s, kKVChunk, c0, 0);
#pragma unroll
  for (int cc = 0; cc < kN; ++cc)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_ss_n32<T>(s, dq + ((cc * kQChunk + 32 * k) >> 4),
                   dk + ((cc * kKVChunk + 32 * k) >> 4), (cc | k) != 0);
  wgmma_commit();
}

__device__ __forceinline__ void s_wait(float* s) {
  wgmma_wait<0>();
  fence_regs<16>(s);
}

template <int kN, typename T>
__device__ __forceinline__ void s_products(float* s, const uint8_t* q_s,
                                           const uint8_t* k_s, int c0) {
  s_begin<kN, T>(s, q_s, k_s, c0);
  s_wait(s);
}

constexpr int kO = 3 * 32;  // fp32 of O a thread: 64 rows x 192

// O *= alpha, skipped where no row of the warp moved its maximum.
__device__ __forceinline__ void rescale_o(float* o, const float* alpha) {
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int j = 0; j < kO / 4; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
  }
}

// O += P V over warpgroup c's columns of the V tile v_s, started; the
// caller waits (wgmma_wait, fence_regs on o).
template <typename T>
__device__ __forceinline__ void pv_begin(float* o, uint32_t (*pa)[4],
                                         const uint8_t* v_s, int c) {
  fence_regs<kO>(o);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) fence_regs<4>(pa[ks]);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    wgmma_rs_mn192<T>(o, pa[ks], mnmajor(v_s, 3 * c, ks));
  wgmma_commit();
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The next tile from it on that either role loads (n_valid > 0), or
// b.n_tiles.
template <bool kWindow>
__device__ __forceinline__ int next_valid(const Block& b, const Args& a,
                                          int it) {
  while (it < b.n_tiles && tile_of<kWindow>(b, a, it).n_valid <= 0) ++it;
  return it;
}

// Third w of tile t's K (kV false) or V into the bf16 tile dst, by the 128
// threads of one warpgroup: from the ring (the staged K or V at src, once
// its "full" barrier's phase of parity `parity` completes; then each warp
// gives the stage's K or V back on `empty`, unless that is null) or, a
// bf16 tail tile beside e5m2, from the tails by cp.async. Each thread
// fences its writes for wgmma; the caller synchronises the warpgroup.
template <typename KV, bool kV, typename T>
__device__ __forceinline__ void stage_third(const Tile& t, bool ring,
                                            const uint8_t* src,
                                            uint64_t* full, uint64_t* empty,
                                            uint32_t parity, const Args& a,
                                            const Block& b, uint8_t* dst,
                                            int w, const Lane& ln) {
  if (ring) {
    wait_phase(full, parity);
    convert_third<KV, kV, T>(src, dst, w, t.n_valid, ln.tid);
    fence_proxy_async();  // the reads before TMA rewrites the stage
    if (empty != nullptr) {
      __syncwarp();
      if (ln.lane == 0) mbar_arrive(empty);
    }
  } else {
    copy_tail<T>(kV ? a.tail_v : a.tail_k, b, a, t.kv0, t.n_valid, dst, w,
                 ln.tid);
    fence_proxy_async();
  }
}

// Float4 i (0..3) of consumer thread tid's part of S in the ragged fp8
// instance: in warpgroup w's own thirds of the tile's staged K (i < 2) and
// V, which only w converted.
__device__ __forceinline__ float4* part_at(uint8_t* k8, int w, int i,
                                           int tid) {
  return reinterpret_cast<float4*>(k8 + (i >> 1) * kKV8Bytes +
                                   w * kKV8Third) +
         128 * (i & 1) + tid;
}

// The tiles of warpgroup ln.c on a cache of q's type T (consume's
// schemes).
template <bool kCap, bool kWindow, typename T, bool kOpts = false>
__device__ __forceinline__ void tiles16(const Args& a, const Block& b,
                                        uint8_t* q_s, uint8_t* kv_s,
                                        uint64_t* bars, Handoff* x,
                                        const Lane& ln, float* o, float* m_r,
                                        float* l_r) {
  const int c = ln.c, tid = ln.tid;
  uint64_t* p_full = bars + kBars;
  uint64_t* p_empty = bars + kBars + 2;
  int n = 0;  // tiles through the ring
  for (int it = 0; it < b.n_tiles; ++it) {
    const Tile t = tile_of<kWindow>(b, a, it);
    if (t.n_valid <= 0) continue;  // as the producer skips it
    const int st = n % kStages, pb = n & 1;
    uint8_t* k_s = kv_s + st * 2 * kKVBytes;
    uint8_t* v_s = k_s + kKVBytes;
    uint64_t* bar = bars + 4 * st;  // K full, K empty, V full, V empty
    const uint32_t parity = (n / kStages) & 1, p_parity = (n >> 1) & 1;
    ++n;
    float alpha[2];
    uint32_t pa[2][4];

    if constexpr (!kWindow) {
      float s[16];
      wait_phase(&bar[0], parity);
      s_products<3, T>(s, q_s, k_s, 3 * c);
      // The parts meet in the K tile (float4 i of thread t of warpgroup w
      // at 768 w + 128 i + t, in w's chunks 3w and 3w + 1).
      float4* part = reinterpret_cast<float4*>(k_s);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        part[768 * c + 128 * i + tid] =
            make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      named_sync(1, 128 * kConsumers);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4 v[kConsumers];
#pragma unroll
        for (int w = 0; w < kConsumers; ++w)
          v[w] = w == c ? make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2],
                                      s[4 * i + 3])
                        : part[768 * w + 128 * i + tid];
        s[4 * i] = (v[0].x + v[1].x) + v[2].x;
        s[4 * i + 1] = (v[0].y + v[1].y) + v[2].y;
        s[4 * i + 2] = (v[0].z + v[1].z) + v[2].z;
        s[4 * i + 3] = (v[0].w + v[1].w) + v[2].w;
      }
      fence_proxy_async();  // these reads, before TMA writes the stage
      __syncwarp();
      if (ln.lane == 0) mbar_arrive(&bar[1]);  // K is read
      softmax_tile<kCap, kWindow, kOpts>(s, t, b, a, ln, m_r, l_r, alpha);
      pack_p<T>(s, pa);
    } else if (c == 0) {
      float s[16];
      wait_phase(&bar[0], parity);
      s_products<kChunks, T>(s, q_s, k_s, 0);
      __syncwarp();
      if (ln.lane == 0) mbar_arrive(&bar[1]);  // K is read
      softmax_tile<kCap, kWindow>(s, t, b, a, ln, m_r, l_r, alpha);
      pack_p<T>(s, pa);
      // Hand P and alpha on: thread tid of warpgroups 1 and 2 holds the
      // same rows and fragments.
      wait_phase(&p_empty[pb], p_parity ^ 1);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        x->p[pb][ks][tid] = make_uint4(pa[ks][0], pa[ks][1], pa[ks][2],
                                       pa[ks][3]);
      if (ln.tq == 0) {
        x->alpha[pb][ln.r0] = alpha[0];
        x->alpha[pb][ln.r0 + 8] = alpha[1];
      }
      mbar_arrive(&p_full[pb]);
    } else {
      wait_phase(&p_full[pb], p_parity);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint4 v = x->p[pb][ks][tid];
        pa[ks][0] = v.x;
        pa[ks][1] = v.y;
        pa[ks][2] = v.z;
        pa[ks][3] = v.w;
      }
      alpha[0] = x->alpha[pb][ln.r0];
      alpha[1] = x->alpha[pb][ln.r0 + 8];
      mbar_arrive(&p_empty[pb]);
    }
    rescale_o(o, alpha);

    wait_phase(&bar[2], parity);
    if (t.n_valid < kKeys) {
      // Rows past the loadable keys hold stale bytes (0 x Inf would be
      // NaN): zero this warpgroup's columns of them.
      const int dead = kKeys - t.n_valid;
      for (int e = tid; e < dead * 3 * 8; e += 128) {
        const int piece = e & 7, rc = e >> 3;
        const int cc = 3 * c + rc / dead, row = t.n_valid + rc % dead;
        *reinterpret_cast<uint4*>(v_s + cc * kKVChunk + row * 128 +
                                  piece * 16) = make_uint4(0, 0, 0, 0);
      }
      fence_proxy_async();
      named_sync(2 + c, 128);
    }
    pv_begin<T>(o, pa, v_s, c);
    wgmma_wait<0>();
    fence_regs<kO>(o);
    __syncwarp();
    if (ln.lane == 0) mbar_arrive(&bar[3]);  // V is read
  }
}

// The ragged instance on an fp8 cache, warpgroup ln.c's tiles: its third
// of K and of V converted into its chunks of the bf16 tiles (kt, vt), V's
// under S's products and the next tile's K under P V's; its part of S in
// its own thirds of the tile's stage (converted by then), which the
// stage's empty barriers give back once every warpgroup has added the
// parts.
template <bool kCap, typename KV, typename T, bool kOpts = false>
__device__ __forceinline__ void ragged_fp8(const Args& a, const Block& b,
                                           uint8_t* q_s, uint8_t* kv_s,
                                           uint64_t* bars, const Lane& ln,
                                           float* o, float* m_r, float* l_r) {
  const int c = ln.c, tid = ln.tid;
  uint8_t* kt = kv_s + kStages * 2 * kKV8Bytes;  // the K tile of T
  uint8_t* vt = kt + kKVBytes;                     // and V tile
  if (b.n_tiles > 0)
    stage_third<KV, false, T>(tile_of<false>(b, a, 0), true, kv_s, &bars[0],
                              nullptr, 0, a, b, kt, c, ln);
  for (int n = 0; n < b.n_tiles; ++n) {
    const Tile t = tile_of<false>(b, a, n);
    uint8_t* k8 = kv_s + (n % kStages) * 2 * kKV8Bytes;
    uint64_t* bar = bars + 4 * (n % kStages);  // K full, K empty, V ...
    const uint32_t parity = (n / kStages) & 1;
    float s[16], alpha[2];
    uint32_t pa[2][4];
    named_sync(2 + c, 128);  // this tile's K in the warpgroup's chunks
    s_begin<3, T>(s, q_s, kt, 3 * c);
    stage_third<KV, true, T>(t, true, k8 + kKV8Bytes, &bar[2], nullptr,
                             parity, a, b, vt, c, ln);
    s_wait(s);
    named_sync(2 + c, 128);  // its thirds of the stage read, V converted
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *part_at(k8, c, i, tid) =
          make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
    named_sync(1, 128 * kConsumers);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 v[kConsumers];
#pragma unroll
      for (int w = 0; w < kConsumers; ++w)
        v[w] = w == c ? make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2],
                                    s[4 * i + 3])
                      : *part_at(k8, w, i, tid);
      s[4 * i] = (v[0].x + v[1].x) + v[2].x;
      s[4 * i + 1] = (v[0].y + v[1].y) + v[2].y;
      s[4 * i + 2] = (v[0].z + v[1].z) + v[2].z;
      s[4 * i + 3] = (v[0].w + v[1].w) + v[2].w;
    }
    fence_proxy_async();  // these reads, before TMA writes the stage
    __syncwarp();
    if (ln.lane == 0) {
      mbar_arrive(&bar[1]);  // the stage's K and V are free
      mbar_arrive(&bar[3]);
    }
    softmax_tile<kCap, false, kOpts>(s, t, b, a, ln, m_r, l_r, alpha);
    pack_p<T>(s, pa);
    rescale_o(o, alpha);
    pv_begin<T>(o, pa, vt, c);
    if (n + 1 < b.n_tiles) {
      const int m = n + 1;
      stage_third<KV, false, T>(tile_of<false>(b, a, m), true,
                                kv_s + (m % kStages) * 2 * kKV8Bytes,
                                bars + 4 * (m % kStages), nullptr,
                                (m / kStages) & 1, a, b, kt, c, ln);
    }
    wgmma_wait<0>();
    fence_regs<kO>(o);
  }
}

// The window instance on an fp8 cache, warpgroup ln.c's tiles: every
// warpgroup converts its third of K (warpgroup 0 then waits for all three
// on named barrier 5, to which the others only arrive) and of V; the next
// tile's K once S's products are done (warpgroup 0: under P V's; the
// others: as soon as P arrives), this tile's V under S's products
// (warpgroup 0) or before P arrives. Stages are given back as converted.
template <bool kCap, typename KV, typename T>
__device__ __forceinline__ void window_fp8(const Args& a, const Block& b,
                                           uint8_t* q_s, uint8_t* kv_s,
                                           uint64_t* bars, Handoff* x,
                                           const Lane& ln, float* o,
                                           float* m_r, float* l_r) {
  const int c = ln.c, tid = ln.tid;
  uint8_t* kt = kv_s + kStages * 2 * kKV8Bytes;  // the K tile of T
  uint8_t* vt = kt + kKVBytes;                     // and V tile
  uint64_t* p_full = bars + kBars;
  uint64_t* p_empty = bars + kBars + 2;
  // This warpgroup's third of tile i's K, tile i being ring tile m.
  auto k_third = [&](int i, int m) {
    const Tile tn = tile_of<true>(b, a, i);
    uint64_t* bar = bars + 4 * (m % kStages);
    stage_third<KV, false, T>(tn, in_ring<KV>(tn),
                              kv_s + (m % kStages) * 2 * kKV8Bytes, &bar[0],
                              &bar[1], (m / kStages) & 1, a, b, kt, c, ln);
  };
  int it = next_valid<true>(b, a, 0);
  if (it < b.n_tiles) {
    k_third(it, 0);
    if (c != 0) named_arrive(5, 128 * kConsumers);
  }
  int n = 0, k = 0;  // tiles through the ring, tiles taken
  while (it < b.n_tiles) {
    const Tile t = tile_of<true>(b, a, it);
    const bool ring = in_ring<KV>(t);
    uint8_t* v8 = kv_s + (n % kStages) * 2 * kKV8Bytes + kKV8Bytes;
    uint64_t* bar = bars + 4 * (n % kStages);
    const uint32_t parity = (n / kStages) & 1;
    const int pb = k & 1;
    const uint32_t p_parity = (k >> 1) & 1;
    const int nxt = next_valid<true>(b, a, it + 1), n_next = n + ring;
    float alpha[2];
    uint32_t pa[2][4];
    if (c == 0) {
      float s[16];
      named_sync(5, 128 * kConsumers);  // K whole
      s_begin<kChunks, T>(s, q_s, kt, 0);
      stage_third<KV, true, T>(t, ring, v8, &bar[2], &bar[3], parity, a, b,
                               vt, c, ln);
      s_wait(s);
      softmax_tile<kCap, true>(s, t, b, a, ln, m_r, l_r, alpha);
      pack_p<T>(s, pa);
      wait_phase(&p_empty[pb], p_parity ^ 1);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        x->p[pb][ks][tid] = make_uint4(pa[ks][0], pa[ks][1], pa[ks][2],
                                       pa[ks][3]);
      if (ln.tq == 0) {
        x->alpha[pb][ln.r0] = alpha[0];
        x->alpha[pb][ln.r0 + 8] = alpha[1];
      }
      mbar_arrive(&p_full[pb]);
    } else {
      stage_third<KV, true, T>(t, ring, v8, &bar[2], &bar[3], parity, a, b,
                               vt, c, ln);
      wait_phase(&p_full[pb], p_parity);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint4 v = x->p[pb][ks][tid];
        pa[ks][0] = v.x;
        pa[ks][1] = v.y;
        pa[ks][2] = v.z;
        pa[ks][3] = v.w;
      }
      alpha[0] = x->alpha[pb][ln.r0];
      alpha[1] = x->alpha[pb][ln.r0 + 8];
      mbar_arrive(&p_empty[pb]);
      if (nxt < b.n_tiles) {  // S is done with the K tile: P came of it
        k_third(nxt, n_next);
        named_arrive(5, 128 * kConsumers);
      }
    }
    rescale_o(o, alpha);
    named_sync(2 + c, 128);  // this tile's V in the warpgroup's chunks
    pv_begin<T>(o, pa, vt, c);
    if (c == 0 && nxt < b.n_tiles) k_third(nxt, n_next);
    wgmma_wait<0>();
    fence_regs<kO>(o);
    n = n_next;
    ++k;
    it = nxt;
  }
}

// The three consumer warpgroups: every tile's S = Q K^T, its softmax and
// O += P V for the warpgroup's columns, then the block's output (ragged)
// or split state (window).
// - Ragged: each warpgroup takes the part of S over its own chunks (12 of
//   the 36 products: three chains side by side, where one warpgroup
//   alone would wait on 36 in a row), writes it to its own chunks of the
//   K tile it has just read (nobody else reads them), and after one
//   barrier adds the three parts in warpgroup order: the same S, softmax
//   and P in each warpgroup, and no hand-off.
// - Window: warpgroup 0 takes S and the softmax and hands P and the rescale
//   factors to the other two (bars[kBars + 0, 1]: P full, [kBars + 2, 3]:
//   P empty, a buffer each): less work a tile (the scheme each instance
//   was faster with on an H100).
// On an fp8 cache the tiles are converted into two bf16 tiles first
// (ragged_fp8, window_fp8; the file's head).
template <bool kCap, bool kWindow, typename T, typename KV,
          bool kOpts = false>
__device__ __forceinline__ void consume(const Args& a, const Block b,
                                        uint8_t* q_s, uint8_t* kv_s,
                                        uint64_t* bars, Handoff* x) {
  Lane ln;
  ln.c = threadIdx.x / 128 - 1;
  ln.tid = threadIdx.x & 127;
  ln.warp = ln.tid >> 5;
  ln.lane = ln.tid & 31;
  ln.tq = ln.lane & 3;
  ln.r0 = 16 * ln.warp + (ln.lane >> 2);
  ln.qp[0] = ln.qp[1] = ln.w_lo = ln.w_hi = 0;
  if constexpr (!kWindow) {
    const int last = b.qlen - 1;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      ln.qp[hf] = b.pos0 + min((b.row_lo + ln.r0 + 8 * hf) / b.group, last);
    ln.w_lo = b.pos0 + min((b.row_lo + 16 * ln.warp) / b.group, last);
    ln.w_hi = b.pos0 + min((b.row_lo + 16 * ln.warp + 15) / b.group, last);
    if constexpr (kOpts) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        ln.s_lo[hf] = 0x7fffffff;
        ln.s_hi[hf] = -1;
        if (a.spans != nullptr)
          attn::row_span(a.spans + (size_t)b.req * a.num_spans * 2,
                         a.num_spans, ln.qp[hf], ln.s_lo[hf], ln.s_hi[hf]);
        // The row's query head: h * group + (row_lo + row) % group.
        ln.sl[hf] = a.alibi != nullptr
                        ? a.alibi[b.h * b.group +
                                  (b.row_lo + ln.r0 + 8 * hf) % b.group]
                        : 0.f;
      }
    }
  }
  const int c = ln.c, tid = ln.tid;

  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  if constexpr (attn::is_fp8<KV>) {
    if constexpr (kWindow)
      window_fp8<kCap, KV, T>(a, b, q_s, kv_s, bars, x, ln, o, m_r, l_r);
    else
      ragged_fp8<kCap, KV, T, kOpts>(a, b, q_s, kv_s, bars, ln, o, m_r,
                                     l_r);
  } else {
    tiles16<kCap, kWindow, T, kOpts>(a, b, q_s, kv_s, bars, x, ln, o, m_r,
                                     l_r);
  }

  // l: the quad's partial sums (of warpgroup 0 in the window).
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l_r[hf] += __shfl_xor_sync(0xffffffffu, l_r[hf], 1);
    l_r[hf] += __shfl_xor_sync(0xffffffffu, l_r[hf], 2);
  }
  if constexpr (!kWindow) {
    // Normalized O goes out through this warpgroup's chunks of Q, which
    // only its own part of S read: in Q's layout (chunk cc of row r at
    // 8192 cc + 128 r, 16-byte piece p at p ^ (r % 8)), then in whole
    // 16-byte pieces of the block's rows.
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = ln.r0 + 8 * hf;
      const float inv = 1.f / fmaxf(l_r[hf], 1e-20f);
#pragma unroll
      for (int j = 0; j < kO / 4; ++j)
        *reinterpret_cast<uint32_t*>(
            q_s + (3 * c + j / 8) * kQChunk + row * 128 +
            (((j & 7) ^ (row & 7)) << 4) + 4 * ln.tq) =
            mma::pack<T>(o[4 * j + 2 * hf] * inv,
                         o[4 * j + 2 * hf + 1] * inv);
    }
    named_sync(2 + c, 128);
    for (int e = tid; e < b.rows * 24; e += 128) {
      const int r = e / 24, rem = e - r * 24;
      const int cc = 3 * c + (rem >> 3), p = rem & 7;
      const int R = b.row_lo + r, tt = R / b.group, g = R - tt * b.group;
      *reinterpret_cast<uint4*>(
          static_cast<T*>(a.out) +
          ((size_t)(b.qstart + tt) * a.nq + b.h * b.group + g) * kHD +
          cc * 64 + p * 8) = *reinterpret_cast<const uint4*>(
          q_s + cc * kQChunk + r * 128 + ((p ^ (r & 7)) << 4));
    }
  } else {
    // The split's unnormalized state: acc for these columns, m (in the
    // scaled logit's units) and l by warpgroup 0.
    const int split = blockIdx.z, splits = gridDim.z;
    const float to_scaled = kCap ? 1.f : a.scale;  // mult x ln 2
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = ln.r0 + 8 * hf;
      if (row >= b.rows) continue;
      const size_t qrow = (size_t)b.req * a.nq + b.h * b.group + b.g0 + row;
      float* dst =
          a.part_acc + (qrow * splits + split) * kHD + 192 * c + 2 * ln.tq;
#pragma unroll
      for (int j = 0; j < kO / 4; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(o[4 * j + 2 * hf], o[4 * j + 2 * hf + 1]);
      if (c == 0 && ln.tq == 0) {
        a.part_m[qrow * splits + split] = m_r[hf] * to_scaled;
        a.part_l[qrow * splits + split] = l_r[hf];
      }
    }
  }
}

template <bool kCap, bool kWindow, typename T, typename KV,
          bool kOpts = false>
__global__ void __launch_bounds__(kThreads, 1)
    mla_kernel(const __grid_constant__ CUtensorMap cache_map,
               const __grid_constant__ CUtensorMap tail_k_map,
               const __grid_constant__ CUtensorMap tail_v_map,
               const __grid_constant__ Args a) {
  const Block b = block_of<kWindow, kOpts>(a);
  if (b.rows <= 0) return;  // a ragged slice past its item's rows
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: TMA, the cp.async of Q
  // and wgmma agree on it for tiles that start on such a boundary.
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // [stage][K, V]; fp8: [stage][K, V] bytes, then the bf16 K and V tiles
  uint8_t* kv_s = q_s + kQBytes;
  Handoff* x = reinterpret_cast<Handoff*>(kv_s + kStages * 2 * kKVBytes);
  // [stage][K full, K empty, V full, V empty], P full [2], P empty [2]
  uint64_t* bars = reinterpret_cast<uint64_t*>(x + 1);
  if (threadIdx.x == 0) {
    // Full: the producer's arrival; empty: each consumer warp's, but for
    // the window's bf16 K, which warpgroup 0 alone reads.
    constexpr bool kK0 = kWindow && !attn::is_fp8<KV>;
    for (int i = 0; i < kBars; ++i)
      mbar_init(&bars[i], (i & 1) == 0       ? 1
                          : (kK0 && i % 4 == 1) ? 4
                                                : kConsumerWarps);
    mbar_init(&bars[kBars], 128);
    mbar_init(&bars[kBars + 1], 128);
    mbar_init(&bars[kBars + 2], 128 * (kConsumers - 1));
    mbar_init(&bars[kBars + 3], 128 * (kConsumers - 1));
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    regs_dealloc<24>();
    if (threadIdx.x < 32)
      produce<kWindow, KV>(a, b, &cache_map, &tail_k_map, &tail_v_map,
                           kv_s, bars);
    return;
  }
  regs_alloc<160>();
  // Q: block row r is query row q_row(r); chunk c of row r at 8192 c + 128
  // r, its 16-byte piece p at p ^ (r % 8).
  const int ct = threadIdx.x - 128;
  for (int e = ct; e < kRows * kChunks * 8; e += 128 * kConsumers) {
    const int r = e / (kChunks * 8), rem = e - r * (kChunks * 8);
    const int c = rem >> 3, p = rem & 7;
    const bool ok = r < b.rows;
    const T* src = static_cast<const T*>(a.q);
    if (ok) {
      size_t row;
      if constexpr (!kWindow) {
        const int R = b.row_lo + r, tt = R / b.group, g = R - tt * b.group;
        row = (size_t)(b.qstart + tt) * a.nq + b.h * b.group + g;
      } else {
        row = (size_t)b.req * a.nq + b.h * b.group + b.g0 + r;
      }
      src += row * kHD + c * 64 + p * 8;
    }
    cp_async16(q_s + c * kQChunk + r * 128 + ((p ^ (r & 7)) << 4), src, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();  // Q's writes, before the products read it
  named_sync(1, 128 * kConsumers);
  consume<kCap, kWindow, T, KV, kOpts>(a, b, q_s, kv_s, bars, x);
}

// One block a query row (r * nq + query head): split::merge_row.
template <typename T, bool kCascade>
__global__ void __launch_bounds__(128)
mla_merge_kernel(const float* __restrict__ part_acc,
                 const float* __restrict__ part_m,
                 const float* __restrict__ part_l, T* __restrict__ out,
                 const float* __restrict__ acc0, const float* __restrict__ m0,
                 const float* __restrict__ l0, int splits) {
  split::merge_row<T, kCascade>(blockIdx.x, part_acc, part_m, part_l, out,
                                   acc0, m0, l0, kHD, splits);
}

// The element a tensor map's key holds: q's 16-bit type (bf16, fp16) or an
// fp8 cache's bytes.
enum MapElem { kElemBf16 = 0, kElemF16 = 1, kElemFp8 = 2 };
template <typename T>
constexpr int kElem16 = std::is_same<T, __half>::value ? kElemF16 : kElemBf16;
// q's dtype code of the instances of T (the attention kernels' AttnDtype).
template <typename T>
constexpr int kQCode = std::is_same<T, __half>::value ? 2 : 1;

// Tensor maps over [rows, 576] in boxes of `box` rows: 16-bit (bf16 or
// fp16) in 64 columns with the 128-byte swizzle, or one-byte (an fp8
// cache's) in 192 columns without one. Encoded once per (base, rows, box,
// element) and kept in a direct-mapped table: a map says where the bytes
// lie, not what they hold, so a tensor written in place needs no new one;
// the element is in the key because one allocation may be seen as bf16
// and, later, as fp16 or fp8 with the same base and rows. The window's
// layers take three each. Each library (the bf16 instances', the fp16
// ones') keeps its own table.
struct MapSlot {
  const void* base;
  uint64_t rows;
  uint32_t box;
  int elem;
  CUtensorMap map;
};
constexpr int kMapSlots = 512;
MapSlot g_maps[kMapSlots];

cudaError_t row_map(CUtensorMap* out, const void* base, uint64_t rows,
                    uint32_t box, int elem) {
  const uint64_t h = (reinterpret_cast<uint64_t>(base) >> 8) * 31 + rows * 7 +
                     box * 3 + elem;
  MapSlot& slot = g_maps[(h ^ (h >> 17)) % kMapSlots];
  if (slot.base != base || slot.rows != rows || slot.box != box ||
      slot.elem != elem) {
    const bool fp8 = elem == kElemFp8;
    const uint64_t dims[2] = {(uint64_t)kHD, rows};
    const uint64_t strides[1] = {(uint64_t)kHD * (fp8 ? 1 : 2)};
    const uint32_t boxd[2] = {(uint32_t)(fp8 ? kThirdCols : 64), box};
    const cudaError_t err =
        fp8 ? make_tma_map_bytes(&slot.map, base, 2, dims, strides, boxd)
        : elem == kElemF16
            ? make_tma_map_16<__half>(&slot.map, base, 2, dims, strides, boxd)
            : make_tma_map_16<bf16>(&slot.map, base, 2, dims, strides, boxd);
    if (err != cudaSuccess) {
      slot.base = nullptr;
      return err;
    }
    slot.base = base;
    slot.rows = rows;
    slot.box = box;
    slot.elem = elem;
  }
  *out = slot.map;
  return cudaSuccess;
}

// Pages the instances take: a multiple of 32 tokens, or 8 or 16 (a tile
// takes whole pages, each box 1024-byte aligned in the swizzle; an fp8
// box of 8 or 16 rows of 192 bytes lands 128-byte aligned, as TMA wants).
bool page_ok(int page) {
  return page > 0 && (page % kKeys == 0 || page == 8 || page == 16);
}

template <bool kCap, bool kWindow, typename T, typename KV, bool kOpts>
int launch(const Args& a, const CUtensorMap& cache, const CUtensorMap& tk,
           const CUtensorMap& tv, dim3 grid, cudaStream_t stream) {
  const cudaError_t err =
      allow_smem<mla_kernel<kCap, kWindow, T, KV, kOpts>>(kSmem);
  if (err != cudaSuccess) return (int)err;
  mla_kernel<kCap, kWindow, T, KV, kOpts>
      <<<grid, kThreads, kSmem, stream>>>(cache, tk, tv, a);
  return (int)cudaGetLastError();
}

// The instance of q's type T for the cache's dtype code (attn_common.cuh
// KvDtype) and the soft cap, with (kOpts) or without the ragged options.
template <typename T, bool kWindow, bool kOpts = false>
int launch_kv(int kv_code, const Args& a, const CUtensorMap& cache,
              const CUtensorMap& tk, const CUtensorMap& tv, dim3 grid,
              cudaStream_t s) {
  const bool cap = a.soft_cap > 0.f;
  switch (kv_code) {
    case kKvAuto:
      return cap ? launch<true, kWindow, T, T, kOpts>(a, cache, tk, tv, grid,
                                                      s)
                 : launch<false, kWindow, T, T, kOpts>(a, cache, tk, tv,
                                                       grid, s);
    case kKvE4M3:
      return cap ? launch<true, kWindow, T, __nv_fp8_e4m3, kOpts>(
                       a, cache, tk, tv, grid, s)
                 : launch<false, kWindow, T, __nv_fp8_e4m3, kOpts>(
                       a, cache, tk, tv, grid, s);
    case kKvE5M2:
      return cap ? launch<true, kWindow, T, __nv_fp8_e5m2, kOpts>(
                       a, cache, tk, tv, grid, s)
                 : launch<false, kWindow, T, __nv_fp8_e5m2, kOpts>(
                       a, cache, tk, tv, grid, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The ragged kernel's MLA instance of q's type T: q [T, nq, 576] (q_code:
// T's dtype code, bf16 1 or fp16 2) and cache layer [P, 2, kvh, page, 576]
// (num_pages = P) in T or fp8 (kv_code: 0, or e4m3fn 1, e5m2 2); block_q
// tokens a work item, whose block_q * (nq / kvh) rows are cut into slices
// of 64 (grid.z). The option instances (kOpts) take ALiBi's slopes alibi
// [nq] fp32 and the image spans [R, num_spans, 2] int32 (num_spans >= 1),
// either null; the others take neither. The arguments as the entry
// points' (mla_attention.cu, mla_opts.cu).
template <typename T, bool kOpts = false>
int ragged_entry(int q_code, int kv_code, const void* q,
                 const void* cache_layer, void* out, const int* item_req,
                 const int* item_qstart, const int* item_qlen,
                 const int* item_pos, const int* seq_lens,
                 const int* block_tables, int num_items, int max_pages,
                 int num_pages, int nq, int kvh, int page_size, int block_q,
                 float scale, int sliding_window, int chunk_attn,
                 float soft_cap, void* stream, const float* alibi = nullptr,
                 const int* spans = nullptr, int num_spans = 0) {
  if (q_code != kQCode<T> || kvh <= 0 || nq % kvh || block_q <= 0 ||
      num_items <= 0 || num_pages <= 0 || !page_ok(page_size) ||
      kv_code < kKvAuto || kv_code > kKvE5M2 ||
      (!kOpts && (alibi != nullptr || spans != nullptr)) ||
      (spans != nullptr && num_spans <= 0))
    return (int)cudaErrorInvalidValue;
  CUtensorMap cache;
  const cudaError_t err =
      row_map(&cache, cache_layer, (uint64_t)num_pages * 2 * kvh * page_size,
              (uint32_t)std::min(page_size, kKeys),
              kv_code != kKvAuto ? kElemFp8 : kElem16<T>);
  if (err != cudaSuccess) return (int)err;
  Args a;
  memset(&a, 0, sizeof(a));
  a.q = q;
  a.out = out;
  a.item_req = item_req;
  a.item_qstart = item_qstart;
  a.item_qlen = item_qlen;
  a.item_pos = item_pos;
  a.seq_lens = seq_lens;
  a.block_tables = block_tables;
  a.max_pages = max_pages;
  a.nq = nq;
  a.kvh = kvh;
  a.page_size = page_size;
  a.box_rows = std::min(page_size, kKeys);
  a.scale = scale;
  a.sliding_window = sliding_window;
  a.chunk_attn = chunk_attn;
  a.soft_cap = soft_cap;
  a.alibi = alibi;
  a.spans = spans;
  a.num_spans = num_spans;
  const int slices = (block_q * (nq / kvh) + kRows - 1) / kRows;
  const dim3 grid(num_items, kvh, slices);
  return launch_kv<T, false, kOpts>(kv_code, a, cache, cache, cache, grid,
                                    static_cast<cudaStream_t>(stream));
}

// The window kernel's MLA instance of q's type T, then its merge, on
// `stream`: q [R, nq, 576] (q_code as ragged_entry's), cache layer
// (num_pages pages) in T or fp8 (kv_code as ragged_entry's) and tails [R,
// kvh, kw, 576] in the cache's dtype, or bf16 beside e5m2 (read by the
// consumers, not by maps, and converted to T), out [R, nq, 576] of T.
// part_acc [R, nq, splits, 576], part_m and part_l [R, nq, splits] fp32
// scratch; acc0 [R, nq, 576], m0 and l0 [R, nq]: the cascade's init state
// covering page positions < shared_len, or all three null.
template <typename T>
int window_entry(int q_code, int kv_code, const void* q,
                 const void* cache_layer, const void* tail_k_layer,
                 const void* tail_v_layer, void* out, float* part_acc,
                 float* part_m, float* part_l, const int* paged_lens,
                 const int* block_tables, int num_reqs, int max_pages,
                 int num_pages, int nq, int kvh, int page_size, int kw,
                 int step, float scale, int sliding_window, int chunk_attn,
                 float soft_cap, const float* acc0, const float* m0,
                 const float* l0, int shared_len, int splits,
                 int tiles_per_split, void* stream) {
  if (q_code != kQCode<T> || (acc0 == nullptr) != (m0 == nullptr) ||
      (acc0 == nullptr) != (l0 == nullptr) || shared_len < 0 ||
      (acc0 == nullptr && shared_len != 0) || kvh <= 0 || nq % kvh ||
      splits < 1 || tiles_per_split < 1 || num_reqs <= 0 || kw <= 0 ||
      num_pages <= 0 || !page_ok(page_size) || kv_code < kKvAuto ||
      kv_code > kKvE5M2)
    return (int)cudaErrorInvalidValue;
  CUtensorMap cache, tk, tv;
  const uint64_t tail_rows = (uint64_t)num_reqs * kvh * kw;
  const uint32_t tail_box = (uint32_t)std::min(kw, kKeys);
  const int elem = kv_code != kKvAuto ? kElemFp8 : kElem16<T>;
  cudaError_t err =
      row_map(&cache, cache_layer, (uint64_t)num_pages * 2 * kvh * page_size,
              (uint32_t)std::min(page_size, kKeys), elem);
  if (kv_code == kKvE5M2) {  // bf16 tails: copied by the consumers
    tk = tv = cache;
  } else {
    if (err == cudaSuccess)
      err = row_map(&tk, tail_k_layer, tail_rows, tail_box, elem);
    if (err == cudaSuccess)
      err = row_map(&tv, tail_v_layer, tail_rows, tail_box, elem);
  }
  if (err != cudaSuccess) return (int)err;
  Args a;
  memset(&a, 0, sizeof(a));
  a.q = q;
  a.part_acc = part_acc;
  a.part_m = part_m;
  a.part_l = part_l;
  a.paged_lens = paged_lens;
  a.tail_k = static_cast<const bf16*>(tail_k_layer);
  a.tail_v = static_cast<const bf16*>(tail_v_layer);
  a.block_tables = block_tables;
  a.max_pages = max_pages;
  a.nq = nq;
  a.kvh = kvh;
  a.page_size = page_size;
  a.box_rows = std::min(page_size, kKeys);
  a.kw = kw;
  a.step = step;
  a.scale = scale;
  a.sliding_window = sliding_window;
  a.chunk_attn = chunk_attn;
  a.soft_cap = soft_cap;
  a.shared_len = shared_len;
  a.tiles_per_split = tiles_per_split;
  const int row_tiles = (nq / kvh + kRows - 1) / kRows;
  const dim3 grid(num_reqs, kvh * row_tiles, splits);
  auto s = static_cast<cudaStream_t>(stream);
  const int e = launch_kv<T, true>(kv_code, a, cache, tk, tv, grid, s);
  if (e != 0) return e;
  const dim3 mgrid(num_reqs * nq);
  if (acc0 != nullptr)
    mla_merge_kernel<T, true><<<mgrid, 128, 0, s>>>(
        part_acc, part_m, part_l, static_cast<T*>(out), acc0, m0, l0,
        splits);
  else
    mla_merge_kernel<T, false><<<mgrid, 128, 0, s>>>(
        part_acc, part_m, part_l, static_cast<T*>(out), nullptr, nullptr,
        nullptr, splits);
  return (int)cudaGetLastError();
}

}  // namespace
