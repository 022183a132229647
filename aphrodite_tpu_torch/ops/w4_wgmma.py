"""The weight-only decode GEMMs on Hopper's warpgroup products, bf16 or
fp16.

``matmul(layout, x, q, scales, zeros)`` launches ``csrc/w4_wgmma.cuh`` for
CUDA tensors, y [M, N] = x [M, K] @ W in x's dtype, bf16 (the instances of
``csrc/w4_wgmma.cu``) or fp16 (``csrc/w4_wgmma_f16.cu``), M <= 256, with W
stored in one of five layouts, one weight a nibble or a byte:

- ``"int4"``: W = (q - z) s, signed int4 q - 8 as uint8 [K/2, N], rows 2r
  and 2r + 1 in the low and high nibble of byte [r, n]
  (``quant_matmul.pack_int4``), zeros z - 8;
- ``"packed"``: W = (q - z) s, uint4 q as uint8 [K/2, N], row r in the low
  nibble and row r + K/2 in the high nibble
  (``quantization.loader.pack_w4``);
- ``"uint4"``: W = (q - z) s, uint4 q one byte a weight, int8 [K, N];
- ``"w8"``: W = q s, int8 q [K, N], one fp32 scale a column, s [N], no
  zeros;
- ``"fp8"``: W = q s, e4m3fn q [K, N], s [N], no zeros (``fp8_matmul`` of
  the JAX package, which XLA computes: no Pallas kernel); with
  ``row_scales`` rs [M] (W8A8, x already rounded to e4m3 in x's dtype) y =
  (d rs[m]) s[n] in fp32, the reference's order.

s and z of the first three are fp32 [K / group, N]. All take the TPU int4
kernel's group-wise form: per group (and per half of K for "packed") d =
x_g @ q_g with q exact in x's dtype, then acc += (d - sum(x_g) z) s in
fp32, and y rounded once to x's dtype, as the TPU kernels compute in x's
dtype (``quant_matmul_pallas.py:38-40, 76``). Where every zero is an
integer that keeps the conversion exact (``zeros_integral``, read at a
weight's first call at each M; the quantizers make them so) the kernel
takes the zero inside the product, d = x_g @ (q_g - z_g) with q - z exact,
and acc += d s: the same sum of exact products, without the sums of x.
"w8" and "fp8" have no groups: d sums a K split's whole range and y =
d s. The wrappers of ``ops/quant_matmul.py`` call it for bf16 and fp16;
CPU tensors never reach it.

What the kernel's launch is made of, computed here and held by the CPU
tests (the kernel runs only on the card):

- ``plan``: rows of M a block (16, 32, 64 or 128, two tiles of 128 above
  128), k16 steps a fold, K splits and the ring's depth;
- ``stage_bytes`` / ``smem_bytes``: the kernel's shared memory (as
  ``stage_geo`` in the source);
- ``schedule``: which rows, columns and byte rows of W each block takes and
  whether it writes y;
- ``fold_model``: the kernel's arithmetic in plain PyTorch (the k range
  each fold sums, both halves of "packed" folded apart, both forms of the
  zero, "w8"'s and "fp8"'s one scale a split);
- ``nibble_model``, ``int8_model`` and ``fp8_model``: the conversions of a
  nibble less its zero, of a signed byte and of an e4m3 byte to bf16 or
  fp16 as the kernel makes them.

``plan``, ``schedule`` and the shared memory do not depend on the dtype:
x's boxes are 2-byte elements in both.

A weight's tensor maps (its bytes, scales, zeros) are encoded once and
kept with the launch's other fixed arguments (``_CALLS``, keyed by
``call_key``: the weight's pointers, shapes and version counters, and M;
held only while the same zeros tensor lives; x's dtype is part of the
key, since it picks the entry and the form of the zero). The form of the
zero is read from the zeros' values, so an in-place write to them (a
weight load) bumps their version and prepares the launch anew. A call
checks x, allocates y and encodes only x's map.
"""
from __future__ import annotations

import ctypes
import math
import weakref
from dataclasses import dataclass

import torch

from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.utils import cdiv

LAYOUTS = {"int4": 0, "packed": 1, "uint4": 2, "w8": 3, "fp8": 4}
BYTE_LAYOUTS = ("uint4", "w8", "fp8")  # one byte a weight, [K, N]
COL_SCALED = ("w8", "fp8")  # no groups or zeros: a scale a column
Q_DTYPES = {"int4": torch.uint8, "packed": torch.uint8, "uint4": torch.int8,
            "w8": torch.int8, "fp8": torch.float8_e4m3fn}
BN = 128          # columns of W a block (two consumer warpgroups of 64)
ROWS = 64         # byte rows of W a stage
CLUSTER = 2       # blocks side by side on N sharing x
M_TILES = (16, 32, 64, 128)
MAX_M = 256
MAX_STAGES = 8
PITCH = 68        # fp32 row pitch of the epilogue's tile
BARRIER_BYTES = 3 * 8  # full, empty and sums mbarriers a stage
MAX_SPLITS = 16

# x's dtype code of the launch (the attention kernels' codes), and the
# library and entry of its instances.
DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}
_LAUNCH_ENTRY = {torch.bfloat16: ("w4_wgmma", "w4_wgmma_launch"),
                 torch.float16: ("w4_wgmma_f16", "w4_wgmma_f16_launch")}
_P, _I = ctypes.c_void_p, ctypes.c_int
_MAP_ARGS = [_P, _P, _P, _I, _I, _I, _I, _P]
_LAUNCH_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P]
_CALLS: dict[tuple, tuple] = {}
# The magic number OR'd under a nibble, whose ulp is 1: bf16 0x4300 (128),
# fp16 0x6400 (1024).
MAGIC = {torch.bfloat16: 0x4300, torch.float16: 0x6400}
# The constant that the conversion subtracts before the zero, by x's
# dtype: c + 8 for int4 (c + (n ^ 8) = c + 8 + n), c for packed and uint4
# (c + u).
ZERO_BASE = {dt: {"int4": c + 8.0, "packed": c, "uint4": c}
             for dt, c in ((torch.bfloat16, 128.0), (torch.float16, 1024.0))}
# Every integer of at most this magnitude is exact: 2^8 in bf16, 2^11 in
# fp16 (their significands' bits).
EXACT_INT = {torch.bfloat16: 256, torch.float16: 2048}
# The values q of the nibble layouts (int4's signed, the others' unsigned).
Q_RANGE = {"int4": (-8, 7), "packed": (0, 15), "uint4": (0, 15)}


@dataclass(frozen=True)
class Plan:
    mt: int          # rows of M a block
    m_tiles: int
    fold: int        # k16 steps a fold (F)
    splits: int      # K splits (grid y)
    chunk_rows: int  # byte rows of W a split, a multiple of ROWS
    gs: int          # groups a stage's half can touch (scale rows a stage)
    stages: int      # the ring's depth


def halves(layout: str) -> int:
    return 2 if layout == "packed" else 1


def x_boxes(layout: str) -> int:
    """x boxes (mt rows x 64 k) a stage multiplies."""
    return 1 if layout in BYTE_LAYOUTS else 2


def byte_rows(layout: str, K: int) -> int:
    """Byte rows of W: K/2 for the nibble layouts, K for the byte ones."""
    return K if layout in BYTE_LAYOUTS else K // 2


def half_steps(layout: str) -> int:
    """k16 steps in one half of a stage (ROWS byte rows)."""
    return 2 * ROWS // 16 if layout == "int4" else ROWS // 16


def fold_steps(layout: str, K: int, group: int) -> int:
    """F, the k16 steps a fold sums: the most (up to a stage's half) whose
    k range, 16 F, divides the group and, for "packed", K/2 (where the
    high half starts), so that no fold straddles a group; "w8" and "fp8",
    which have no groups, a whole stage. The kernel has F in {2, 4, 8} for
    int4, {1, 2, 4} for packed, {2, 4} for uint4 and 4 for w8 and fp8."""
    f = half_steps(layout)
    if layout in COL_SCALED:
        return f
    while group % (16 * f) or (layout == "packed" and (K // 2) % (16 * f)):
        f //= 2
    return f


def m_tile(M: int) -> tuple[int, int]:
    """(rows of M a block, M tiles): the smallest of M_TILES that holds M,
    or tiles of 128 above it."""
    for mt in M_TILES:
        if M <= mt:
            return mt, 1
    return M_TILES[-1], cdiv(M, M_TILES[-1])


def half_ranges(layout: str, K: int, r0: int, rows: int):
    """The k ranges of x [k0, k1) that the halves of a stage at byte rows
    [r0, r0 + rows) multiply: int4's rows hold k 2r and 2r + 1, packed's
    low nibbles k = r and high nibbles k = K/2 + r, a byte row k = r."""
    if layout == "int4":
        return [(2 * r0, 2 * (r0 + rows))]
    if layout == "packed":
        return [(r0, r0 + rows), (K // 2 + r0, K // 2 + r0 + rows)]
    return [(r0, r0 + rows)]


def groups_touched(k0: int, k1: int, group: int) -> int:
    return (k1 - 1) // group - k0 // group + 1


def split_unit(layout: str, group: int) -> int:
    """Byte rows a K split is a multiple of: whole stages and whole groups
    (of the low half for "packed"; "w8" and "fp8" have no groups)."""
    if layout in COL_SCALED:
        return ROWS
    g_rows = group // 2 if layout == "int4" else group
    return ROWS * g_rows // math.gcd(ROWS, g_rows)


def groups_per_stage(layout: str, K: int, group: int) -> int:
    """The most groups that one half of one stage touches (stages start at
    multiples of ROWS byte rows and run whole; rows past the end read
    zeros): the rows of scales and zeros a stage holds, 0 for "w8" and "fp8"
    (their scales are read by the epilogue)."""
    if layout in COL_SCALED:
        return 0
    most = 1
    for r0 in range(0, byte_rows(layout, K), ROWS):
        for k0, k1 in half_ranges(layout, K, r0, ROWS):
            most = max(most, groups_touched(k0, k1, group))
    return most


def stage_bytes(layout: str, mt: int, gs: int, fold: int) -> int:
    """One stage: the weights, the x boxes of mt x 64 bf16, scales and
    zeros [halves][gs][BN] fp32, the sums of x [halves][folds][mt] fp32,
    rounded up to the swizzle's 1024-byte period."""
    h = halves(layout)
    folds = half_steps(layout) // fold
    raw = (ROWS * BN + x_boxes(layout) * mt * 128 + 2 * h * gs * BN * 4
           + h * folds * mt * 4)
    return cdiv(raw, 1024) * 1024


def smem_bytes(layout: str, mt: int, gs: int, fold: int,
               stages: int) -> int:
    """The launch's dynamic shared memory: the ring, its barriers, the
    last-block flag, and up to 1024 bytes to align the ring."""
    return (stages * (stage_bytes(layout, mt, gs, fold) + BARRIER_BYTES)
            + 16 + 1024)


def ring_stages(layout: str, mt: int, gs: int, fold: int,
                allowed: int = cuda_build.H100_SMEM_OPTIN,
                most: int = MAX_STAGES) -> int:
    """The deepest ring (at most ``most`` stages) that fits ``allowed``
    bytes; its stages must also hold the epilogue's two fp32 tiles of mt x
    64."""
    for stages in range(most, 1, -1):
        if smem_bytes(layout, mt, gs, fold, stages) <= allowed:
            if stages * stage_bytes(layout, mt, gs, fold) \
                    < 2 * mt * PITCH * 4:
                break
            return stages
    raise RuntimeError(
        f"w4_wgmma {layout} mt={mt}: two stages need "
        f"{smem_bytes(layout, mt, gs, fold, 2)} bytes of shared memory; the "
        f"card allows {allowed}")


def plan(layout: str, M: int, K: int, N: int, group: int,
         sms: int = cuda_build.H100_SMS,
         allowed: int = cuda_build.H100_SMEM_OPTIN,
         splits: int | None = None, stages: int | None = None) -> Plan:
    """The launch of one call. K splits (on whole stages and groups) fill
    the card with one wave of blocks, one block an SM: as many as keep
    blocks x splits <= sms, none where the column and M tiles alone fill
    it (the weights stream at the memory's rate either way; a second,
    partial wave of split blocks and the splits' fp32 partial sums cost
    more than a wave of fewer, longer blocks: PERF.md), the chunks
    as even as K's units allow. ``splits`` forces a count (at most the
    units K has), ``stages`` caps the ring's depth."""
    mt, m_tiles = m_tile(M)
    unit = split_unit(layout, group)
    units = cdiv(byte_rows(layout, K), unit)
    blocks = cdiv(cdiv(N, BN), CLUSTER) * CLUSTER * m_tiles
    want = splits or min(sms // blocks, MAX_SPLITS)
    per = cdiv(units, max(1, min(want, units)))
    gs = groups_per_stage(layout, K, group)
    fold = fold_steps(layout, K, group)
    return Plan(mt, m_tiles, fold, cdiv(units, per), per * unit, gs,
                ring_stages(layout, mt, gs, fold, allowed,
                            stages or MAX_STAGES))


def schedule(layout: str, p: Plan, M: int, K: int, N: int):
    """The kernel's blocks in its own arithmetic: for each (x, y) of the
    grid, the cluster rank, the column tile, the rows of M, the byte rows
    of W [r_begin, r_end), and whether the block writes its tile (a block
    past N, the odd tile count's partner, writes nothing). With splits
    the last block of a (column tile, M tile) writes y for all of them."""
    pairs = cdiv(cdiv(N, BN), CLUSTER)
    rows = byte_rows(layout, K)
    out = []
    for by in range(p.splits):
        for bx in range(pairs * p.m_tiles * CLUSTER):
            rank, pm = bx % CLUSTER, bx // CLUSTER
            mt_idx, tile = pm % p.m_tiles, (pm // p.m_tiles) * CLUSTER + rank
            r_begin = by * p.chunk_rows
            out.append(dict(
                rank=rank, tile=tile, split=by,
                cols=(tile * BN, min(N, tile * BN + BN)),
                rows=(mt_idx * p.mt, min(M, mt_idx * p.mt + p.mt)),
                k_rows=(r_begin, min(rows, r_begin + p.chunk_rows)),
                writes=tile * BN < N))
    return out


def zeros_integral(layout: str, zeros: torch.Tensor,
                   dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the kernel may take the zeros inside the product for x of
    ``dtype``: every zero z an integer with the conversion's subtrahend
    ZERO_BASE + z and every q - z (q over ``Q_RANGE``) at most
    ``EXACT_INT`` in magnitude (256 in bf16, 2048 in fp16), so that both
    are exact in ``dtype`` and so is the subtraction (``nibble_model``).
    Reads the zeros once."""
    v = zeros.float()
    lo, hi = Q_RANGE[layout]
    most = EXACT_INT[dtype]
    return bool(torch.equal(v, v.round())
                and (ZERO_BASE[dtype][layout] + v).abs().max().item() <= most
                and torch.maximum((v - lo).abs(), (v - hi).abs()).max()
                .item() <= most)


def _bits(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """16-bit patterns (int32 holding 0..0xFFFF) as values of ``dtype``
    (the cast to int16 wraps the sign bit)."""
    return bits.to(torch.int16).view(dtype)


def nibble_model(layout: str, n: torch.Tensor, z: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's conversion of stored nibbles n (0..15) less their zeros
    z into ``dtype`` (``convert_int4``, ``convert_packed``): the bits
    MAGIC | n (int4: MAGIC | (n ^ 8)) are c + u with c 128 (bf16) or 1024
    (fp16), whose ulp is 1; one subtraction of ZERO_BASE + z, rounded to
    ``dtype`` as the kernel packs it, leaves q - z (int4's q the signed
    n ^ 8 - 8). Without the zero inside the product z is 0. Returns
    ``dtype`` of the broadcast shape."""
    u = n.to(torch.int32) & 0xF
    c_u = _bits((u ^ 8 if layout == "int4" else u) | MAGIC[dtype], dtype)
    sub = (ZERO_BASE[dtype][layout] + z.float()).to(dtype)
    return c_u - sub


def int8_model(b: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's conversion of signed bytes to ``dtype`` (``int8_pair``).
    bf16: the fp32 of bits 0x4B000000 | (b ^ 0x80) is 2^23 + 128 + b, one
    fp32 subtraction of 2^23 + 128 leaves b, and b (at most 8 significant
    bits) rounds to bf16 exactly. fp16: the bits 0x6400 | (b ^ 0x80) are
    1024 + 128 + b (ulp 1 below 2048), and one fp16 subtraction of 1152
    leaves b. Returns ``dtype`` of b's shape."""
    if dtype == torch.float16:
        f = _bits(0x6400 | ((b.to(torch.int32) & 0xFF) ^ 0x80), dtype)
        return f - torch.tensor(1152.0, dtype=dtype)
    bits = 0x4B000000 | ((b.to(torch.int32) & 0xFF) ^ 0x80)
    return (bits.view(torch.float32) - 8388736.0).to(torch.bfloat16)


def fp8_model(b: torch.Tensor,
              dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's conversion of e4m3 bytes (uint8) to ``dtype``
    (``e4m3_pair``). bf16: the bits (b & 0x80) << 8 | (b & 0x7f) << 4 are
    the bf16 of 2^-120 times the e4m3 value (a bf16 subnormal below
    2^-126), and one bf16 product with 2^120 restores it. fp16: the kernel
    takes the hardware's cvt.rn.f16x2.e4m3x2, which is exact; modelled by
    the bits (b & 0x80) << 8 | (b & 0x7f) << 7, the fp16 of 2^-8 times the
    e4m3 value (exponent biases 15 and 7; subnormals map to subnormals),
    and one product with 2^8. Both exact for every finite byte. Returns
    ``dtype`` of b's shape."""
    v = b.to(torch.int32) & 0xFF
    shift, scale = (7, 2.0 ** 8) if dtype == torch.float16 else (4, 2.0 ** 120)
    tiny = _bits(((v & 0x80) << 8) | ((v & 0x7F) << shift), dtype)
    return tiny * torch.tensor(scale, dtype=dtype)


def fold_model(layout: str, x: torch.Tensor, q: torch.Tensor,
               scales: torch.Tensor, zeros: torch.Tensor | None,
               p: Plan, zero_in: bool = False,
               row_scales: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's arithmetic in fp32: for each K split, stage and half,
    d = x_f @ q_f over each fold's k range f (16 F k, cut at the last real
    row; q exact, x as given), then acc += (d - sum(x_f) z_g) s_g with g
    the fold's group; with ``zero_in``, d = x_f @ (q_f - z_g) and acc +=
    d s_g. "w8" and "fp8" sum d over the split's stages and take acc = d s
    ("fp8" with ``row_scales``: (d rs) s). The splits' sums are added in
    split order. Returns fp32 [M, N]."""
    from aphrodite_tpu_torch.ops.quant_matmul import unpack_int4
    M, K = x.shape
    N = q.shape[1]
    rows = byte_rows(layout, K)
    if layout == "int4":
        qk = unpack_int4(q).float()                       # [K, N], k order
    elif layout == "packed":
        b = q.to(torch.int16)
        qk = torch.cat([b & 0xF, (b >> 4) & 0xF]).float()
    else:
        qk = q.float()
    xf, s = x.float(), scales.float()
    y = torch.zeros((M, N), dtype=torch.float32)
    for sp in range(p.splits):
        acc = torch.zeros((M, N), dtype=torch.float32)
        r_end = min(rows, (sp + 1) * p.chunk_rows)
        for r0 in range(sp * p.chunk_rows, r_end, ROWS):
            for k0, k1 in half_ranges(layout, K, r0, min(ROWS, r_end - r0)):
                if layout in COL_SCALED:
                    acc += xf[:, k0:k1] @ qk[k0:k1]
                    continue
                group = K // s.shape[0]
                z = zeros.float()
                for a in range(k0, k1, 16 * p.fold):
                    b, g = min(k1, a + 16 * p.fold), a // group
                    assert (b - 1) // group == g  # within one group
                    if zero_in:
                        acc += (xf[:, a:b] @ (qk[a:b] - z[g])) * s[g]
                        continue
                    d = xf[:, a:b] @ qk[a:b]
                    xs = xf[:, a:b].sum(dim=1, keepdim=True)
                    acc += (d - xs * z[g]) * s[g]
        if row_scales is not None:
            acc = acc * row_scales.float()[:, None]
        y += acc * s if layout in COL_SCALED else acc
    return y


# -------------------------------------------------------------------- launch
def check(layout: str, x: torch.Tensor, q: torch.Tensor,
          scales: torch.Tensor, zeros: torch.Tensor | None,
          row_scales: torch.Tensor | None = None) -> int:
    """Raise ValueError, naming the shape, on what the kernel cannot take;
    return the group (K for "w8" and "fp8"). It takes bf16 or fp16 x [M, K]
    with 1 <= M <= 256 and K a multiple of 32; q uint8 [K/2, N] (int4, packed),
    int8 [K, N] (uint4, w8) or e4m3fn [K, N] (fp8) with N a multiple of 16
    (TMA's row stride); fp32 scales and zeros [K / group, N] with the group
    a multiple of 32, or for "w8" and "fp8" fp32 scales [N] and no zeros;
    for "fp8" optionally fp32 row scales [M]; all contiguous and 16-byte
    aligned on x's device."""
    what = f"w4_wgmma {layout}"
    if x.dtype not in DTYPE_CODES or x.dim() != 2:
        raise ValueError(f"{what}: x must be bf16 or fp16 [M, K], got "
                         f"{x.dtype} {tuple(x.shape)}")
    M, K = x.shape
    q_dtype = Q_DTYPES[layout]
    if q.dim() != 2 or q.dtype != q_dtype \
            or q.shape[0] != byte_rows(layout, K):
        raise ValueError(f"{what}: q must be {q_dtype} "
                         f"[{byte_rows(layout, K)}, N], got {q.dtype} "
                         f"{tuple(q.shape)}")
    N = q.shape[1]
    if not (1 <= M <= MAX_M) or K % 32 or N % 16 or N < 16:
        raise ValueError(f"{what}: M={M}, K={K}, N={N}: needs 1 <= M <= "
                         f"{MAX_M}, K a multiple of 32 and N of 16")
    if row_scales is not None and (layout != "fp8" or tuple(
            row_scales.shape) != (M,)):
        raise ValueError(f"{what}: row scales are fp8's, [{M}]")
    if layout in COL_SCALED:
        if tuple(scales.shape) != (N,) or zeros is not None:
            raise ValueError(f"{what}: want scales [{N}] and no zeros, got "
                             f"{tuple(scales.shape)}")
        G = 1
    else:
        G = scales.shape[0] if scales.dim() == 2 else 0
        if G < 1 or K % G or tuple(scales.shape) != (G, N) or zeros is None \
                or tuple(zeros.shape) != (G, N) or (K // G) % 32:
            raise ValueError(
                f"{what}: scales {tuple(scales.shape)} / zeros "
                f"{None if zeros is None else tuple(zeros.shape)} for K={K}, "
                f"N={N}: want [K / group, N] with the group a multiple of 32")
    for name, t, dtype in (("x", x, x.dtype), ("q", q, q_dtype),
                           ("scales", scales, torch.float32),
                           ("zeros", zeros, torch.float32),
                           ("row_scales", row_scales, torch.float32)):
        if t is None:
            continue
        if t.device != x.device or t.dtype != dtype \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous, 16-byte "
                             f"aligned {dtype} on {x.device}")
    return K // G


def _version(t: torch.Tensor | None):
    """t's version counter, which every in-place write bumps (inference
    tensors have none: they cannot be written outside inference mode)."""
    return None if t is None or t.is_inference() else t._version


def call_key(layout: str, x: torch.Tensor, q: torch.Tensor,
             scales: torch.Tensor, zeros: torch.Tensor | None,
             *extra) -> tuple:
    """The key of a prepared launch in ``_CALLS``: the layout, x's shape,
    dtype (which picks the entry, the instance and the form of the zero)
    and device, and for q, scales and zeros their address, shape, dtype
    and version counter (so that a weight written in place, as
    ``loader.weights.load_params`` does, is prepared anew: its form of the
    zero was read from the old values), then ``extra``."""
    key = [layout, tuple(x.shape), x.dtype, x.device.index, *extra]
    for t in (q, scales, zeros):
        key += ([None] if t is None else
                [t.data_ptr(), tuple(t.shape), t.dtype, _version(t)])
    return tuple(key)


def _entries(lib, dtype: torch.dtype):
    """(w4_weight_maps, the launch entry of x's ``dtype``) of the package's
    builds, or of ``lib``, a ``ctypes.CDLL`` of another build of
    ``csrc/w4_wgmma.cu`` (the timing variants: bf16 only)."""
    if lib is None:
        return (cuda_build.entry("w4_wgmma", "w4_weight_maps", _MAP_ARGS),
                cuda_build.entry(*_LAUNCH_ENTRY[dtype], _LAUNCH_ARGS))
    if dtype != torch.bfloat16:
        raise ValueError("w4_wgmma: the timing variants build the bf16 "
                         f"instances only, got {dtype}")
    fns = (lib.w4_weight_maps, lib.w4_wgmma_launch)
    for fn, args in zip(fns, (_MAP_ARGS, _LAUNCH_ARGS)):
        fn.argtypes, fn.restype = args, ctypes.c_int
    return fns


def _prepare(layout, x, q, scales, zeros, splits, lib, zero_in, stages):
    """The fixed part of a launch (checked once): the entry point of x's
    dtype, the weight's tensor maps, the launch's integer arguments, the
    plan, w8's and fp8's column scales, and a weak reference to the zeros
    it was made for."""
    group = check(layout, x, q, scales, zeros)
    if layout in COL_SCALED:
        zero_in = True  # no zeros: nothing to subtract
    elif zero_in is None:
        zero_in = zeros_integral(layout, zeros, x.dtype)
    M, K = x.shape
    N = q.shape[1]
    p = plan(layout, M, K, N, group, cuda_build.sm_count(x.device),
             cuda_build.smem_optin(), splits, stages)
    map_fn, fn = _entries(lib, x.dtype)
    maps = (ctypes.c_uint8 * 384)()
    G = scales.shape[0] if layout not in COL_SCALED else 0
    err = map_fn(q.data_ptr(), scales.data_ptr(),
                 None if zeros is None else zeros.data_ptr(),
                 byte_rows(layout, K), N, G, p.gs, ctypes.addressof(maps))
    if err:
        raise RuntimeError(f"w4_wgmma weight maps K={K} N={N} group={group}"
                           f": CUDA error {err}")
    args = (ctypes.c_int * 14)(LAYOUTS[layout], p.mt, p.fold, M, K, N, group,
                               p.gs, p.splits, p.chunk_rows, p.m_tiles,
                               p.stages, int(zero_in), DTYPE_CODES[x.dtype])
    return fn, maps, args, p, N, \
        scales.data_ptr() if layout in COL_SCALED else None, \
        f"w4_wgmma {layout} {x.dtype} M={M} K={K} N={N} group={group} " \
        f"({p}, zeros in the product: {bool(zero_in)})", \
        None if zeros is None else weakref.ref(zeros)


def matmul(layout: str, x: torch.Tensor, q: torch.Tensor,
           scales: torch.Tensor, zeros: torch.Tensor | None,
           splits: int | None = None, lib=None,
           zero_in: bool | None = None,
           stages: int | None = None,
           row_scales: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ W on the card, [M, N] in x's dtype (``zeros`` None for "w8" and
    "fp8"; ``row_scales`` fp32 [M] for fp8's W8A8 epilogue). ``splits``
    forces a K split count, ``zero_in`` the form of the zero (None: inside
    the product where ``zeros_integral``), ``stages`` caps the ring's
    depth; ``lib`` runs another build of the source (the timing variants).
    Raises on what the kernel cannot take and on a failed launch; nothing
    falls back."""
    dev = x.device
    key = call_key(layout, x, q, scales, zeros, splits, lib, zero_in,
                   stages, row_scales is not None)
    call = _CALLS.get(key)
    if call is None or (call[-1] is not None and call[-1]() is not zeros):
        if len(_CALLS) > 4096:
            _CALLS.clear()
        call = _CALLS[key] = _prepare(layout, x, q, scales, zeros, splits,
                                      lib, zero_in, stages)
    if row_scales is not None and (
            row_scales.dtype != torch.float32 or row_scales.device != dev
            or not row_scales.is_contiguous()
            or tuple(row_scales.shape) != (x.shape[0],)):
        check(layout, x, q, scales, zeros, row_scales)  # raises
    if not x.is_contiguous() or x.data_ptr() % 16:
        check(layout, x, q, scales, zeros)  # raises, naming the fault
    fn, maps, args, p, N, col_scales, what, _ = call
    out = torch.empty((x.shape[0], N), dtype=x.dtype, device=dev)
    partial = counters = None
    if p.splits > 1:
        tiles = cdiv(cdiv(N, BN), CLUSTER) * CLUSTER * p.m_tiles
        partial, counters = cuda_build.split_workspace(
            dev, p.splits * x.shape[0] * N, tiles)
    err = fn(args, maps, x.data_ptr(), out.data_ptr(), partial, counters,
             col_scales, None if row_scales is None else row_scales.data_ptr(),
             cuda_build.stream(dev))
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")
    return out
