"""Quantized GEMMs for decode-sized M: y = x @ dequant(W).

Four wrappers, each replacing one TPU kernel of
``aphrodite_tpu/ops/quant_matmul_pallas.py``, and a fifth for the fp8
weights that the JAX package leaves to XLA (``fp8_matmul``,
``aphrodite_tpu/ops/quant_gemm.py:74-119``):

- ``w8a16_matmul`` (``w8a16_matmul_pallas``): int8 [K, N] times fp32
  per-column scales [N];
- ``w4a16_matmul`` (``w4a16_matmul_pallas``): uint4 held in int8 [K, N],
  ``W = (q - z) * s`` with fp32 scales and zeros [K/group, N];
- ``w4a16_packed_matmul`` (``w4a16_packed_matmul_pallas``): the same W
  from uint8 [K/2, N], byte [r, n] holding row r in its low nibble and row
  r + K/2 in its high nibble;
- ``w4a16_int4_matmul`` (``w4a16_int4_matmul_pallas``): signed int4
  ``q4 = q - 8`` and zeros ``z - 8`` (``loader.weights.realize_int4_leaves``),
  stored as uint8 [K/2, N] of two's-complement nibbles, byte [r, n]
  holding row 2r in its low nibble and row 2r + 1 in its high nibble: the
  consecutive pair of k that one 32-bit register of a tensor-core A
  operand takes;
- ``fp8_matmul``: e4m3fn [K, N] times fp32 per-column scales [N], and for
  W8A8 an fp32 scale a row of x [M] (x already rounded to e4m3 and held
  in x's dtype): y = ((x @ q) rs[m]) s[n].

On CPU tensors each runs its plain PyTorch version (``ref_*``); a CUDA
tensor launches a kernel or raises. In bf16 and fp16 all five layouts run
on ``ops/w4_wgmma.py`` (``csrc/w4_wgmma.cuh``: wgmma with the weights
converted to x's dtype in registers, TMA rings, x shared across a
cluster; y in x's dtype, as the TPU kernels return it) in
the TPU int4 kernel's group-wise form: per group of K rows one product
``d = x_g @ q_g`` in fp32, then ``acc += (d - sum(x_g) * z) * s``, so s
and z touch the [M, N] group result, not each weight; W8 sums d over the
whole K and scales the fp32 sum by s[n], and fp8 likewise (its rs[m]
first). fp32 runs the CUDA-core kernels
of ``csrc/quant_matmul.cu`` in fp32 throughout (int4 in the group-wise
form, the others in the direct one ``(q - z) * s``). Each wrapper counts
its launches, and by x's dtype (``dtype_launches``: which instance ran).
"""
from __future__ import annotations

import ctypes

import torch

from aphrodite_tpu_torch.ops import cuda_build, w4_wgmma
from aphrodite_tpu_torch.ops.cuda_build import GEMM_DTYPE_CODES as DTYPE_CODES
from aphrodite_tpu_torch.utils import cdiv

_P, _I = ctypes.c_void_p, ctypes.c_int
_W8_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_W4_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_W4I4_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
              _P]
_FP8_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
# Columns per block and the split granularity in stored rows of the fp32
# CUDA-core kernel (kBlockN, kTileK).
_BLOCK_N, _TILE_K = 128, 128
_PLANS: dict[tuple, tuple[int, int, int]] = {}
# The fp32 int4 kernel: columns per block (one a thread) and the rows of
# K staged at a time, which splits fall on too.
_I4_BLOCK_N = 128
_I4_TILE_K = 256
_BLOCKS_PER_SM = 2   # K splits are added until the grid has this many


# ---------------------------------------------------------------- plain twins
def unpack_w4(qpacked: torch.Tensor) -> torch.Tensor:
    """uint8 [K/2, N] -> uint4-in-int8 [K, N] (inverse of ``pack_w4``)."""
    p = qpacked.to(torch.int16)
    return torch.cat([p & 0xF, (p >> 4) & 0xF], dim=0).to(torch.int8)


def pack_int4(q4: torch.Tensor) -> torch.Tensor:
    """int8 [K, N] in [-8, 8) -> uint8 [K/2, N], byte [r, n] holding row 2r
    in bits 0-3 and row 2r + 1 in bits 4-7 (two's complement nibbles)."""
    q = q4.to(torch.int16) & 0xF
    return (q[0::2] | (q[1::2] << 4)).to(torch.uint8)


def unpack_int4(q4p: torch.Tensor) -> torch.Tensor:
    """uint8 [K/2, N] -> int8 [K, N] in [-8, 8) (inverse of ``pack_int4``)."""
    b = q4p.to(torch.int16)
    pair = torch.stack([b & 0xF, (b >> 4) & 0xF], dim=1)   # [K/2, 2, N]
    return (((pair ^ 8) - 8).to(torch.int8)
            .reshape(2 * q4p.shape[0], *q4p.shape[1:]))


def dequant_w4(q: torch.Tensor, scales: torch.Tensor,
               zeros: torch.Tensor) -> torch.Tensor:
    """fp32 [K, N] = (q - z) * s, groups of K / G rows."""
    K, N = q.shape
    G = scales.shape[0]
    w = (q.float().reshape(G, K // G, N) - zeros.float()[:, None, :]) \
        * scales.float()[:, None, :]
    return w.reshape(K, N)


def ref_w8a16_matmul(x: torch.Tensor, qweight: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    return ((x.float() @ qweight.float()) * scales.float()).to(x.dtype)


def ref_fp8_matmul(x: torch.Tensor, qweight: torch.Tensor,
                   scales: torch.Tensor,
                   row_scales: torch.Tensor | None = None) -> torch.Tensor:
    """((x @ q) [* rs[m]]) * s[n] in fp32, e4m3 exact in fp32."""
    acc = x.float() @ qweight.float()
    if row_scales is not None:
        acc = acc * row_scales.float()[:, None]
    return (acc * scales.float()).to(x.dtype)


def ref_w4a16_matmul(x: torch.Tensor, qweight: torch.Tensor,
                     scales: torch.Tensor,
                     zeros: torch.Tensor) -> torch.Tensor:
    return (x.float() @ dequant_w4(qweight, scales, zeros)).to(x.dtype)


def ref_w4a16_packed_matmul(x: torch.Tensor, qpacked: torch.Tensor,
                            scales: torch.Tensor,
                            zeros: torch.Tensor) -> torch.Tensor:
    return ref_w4a16_matmul(x, unpack_w4(qpacked), scales, zeros)


def ref_w4a16_int4_matmul(x: torch.Tensor, q4p: torch.Tensor,
                          scales: torch.Tensor,
                          zeros: torch.Tensor) -> torch.Tensor:
    """The group-wise form of the TPU ``_w4i4_kernel``, in fp32: y = sum
    over groups g of (x_g @ q4_g - sum(x_g) z_g) s_g."""
    M, K = x.shape
    G, N = scales.shape
    xg = x.float().reshape(M, G, K // G).transpose(0, 1)       # [G, M, g]
    d = xg @ unpack_int4(q4p).float().reshape(G, K // G, N)    # [G, M, N]
    xs = xg.sum(dim=2)                                         # [G, M]
    y = (d - xs[:, :, None] * zeros.float()[:, None, :]) \
        * scales.float()[:, None, :]
    return y.sum(dim=0).to(x.dtype)


# -------------------------------------------------------------------- launch
def _plan(M: int, N: int, rows: int, block_n: int, unit: int,
          device: torch.device) -> tuple[int, int, int]:
    """(MT, splits, chunk): rows of M per block, K splits, and stored
    weight rows per split, a multiple of ``unit``. Splits are added until
    the grid of ``block_n``-column blocks has about two blocks per SM
    (N = 4096 alone gives 16-32 column blocks)."""
    key = (M, N, rows, block_n, unit, device.index)
    plan = _PLANS.get(key)
    if plan is None:
        mt = 8 if M <= 8 else 16 if M <= 16 else 32
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        blocks = cdiv(N, block_n) * cdiv(M, mt)
        units = cdiv(rows, unit)
        want = max(1, min(units, cdiv(_BLOCKS_PER_SM * sms, blocks)))
        per = cdiv(units, want)
        plan = _PLANS[key] = (mt, cdiv(units, per), per * unit)
    return plan


def _check(x: torch.Tensor, tensors: dict, K: int, N: int) -> None:
    if x.dtype not in DTYPE_CODES or x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"x must be fp32, bf16 or fp16 [M, {K}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if N % 4:
        raise ValueError(f"N = {N} must be a multiple of 4")
    for name, (t, dtype) in tensors.items():
        if t.device != x.device or t.dtype != dtype \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: want contiguous, 16-byte aligned "
                             f"{dtype} on {x.device}, got {t.dtype} on "
                             f"{t.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _count(fn, x: torch.Tensor) -> None:
    """One launch of wrapper ``fn`` on x's dtype."""
    fn.launches += 1
    fn.dtype_launches[str(x.dtype).removeprefix("torch.")] += 1


def _wgmma(fn, layout: str, x: torch.Tensor, *args, **kw) -> torch.Tensor:
    """``fn``'s bf16 or fp16 launch: ``w4_wgmma.matmul``, counted."""
    out = w4_wgmma.matmul(layout, x, *args, **kw)
    _count(fn, x)
    return out


def _launch(symbol: str, argtypes: list, x: torch.Tensor, rows: int,
            N: int, ptrs: list, dims: list) -> torch.Tensor:
    """Call ``symbol(dtype, mt, x, *ptrs, out, partial, counters, *dims,
    splits, chunk, stream)`` of the fp32 CUDA-core kernel; ``rows`` is the
    number of stored weight rows."""
    M = x.shape[0]
    mt, splits, chunk = _plan(M, N, rows, _BLOCK_N, _TILE_K, x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    partial = counters = None
    if splits > 1:
        partial, counters = cuda_build.split_workspace(
            x.device, splits * M * N, cdiv(N, _BLOCK_N) * cdiv(M, mt))
    fn = cuda_build.entry("quant_matmul", symbol, argtypes)
    err = fn(DTYPE_CODES[x.dtype], mt, x.data_ptr(), *ptrs, out.data_ptr(),
             partial, counters, *dims, splits, chunk,
             cuda_build.stream(x.device))
    cuda_build.check(err, f"quant_matmul {symbol}")
    return out


def w8a16_matmul(x: torch.Tensor, qweight: torch.Tensor,
                 scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ (int8 [K, N] * scales [N]) -> [M, N] in x's dtype.

    bf16 and fp16 run on ``w4_wgmma`` (M <= 256, K a multiple of 32, N of
    16), fp32 on the CUDA-core kernel (N a multiple of 4)."""
    if x.device.type == "cpu":
        return ref_w8a16_matmul(x, qweight, scales)
    if x.dtype in w4_wgmma.DTYPE_CODES:
        return _wgmma(w8a16_matmul, "w8", x, qweight, scales, None)
    K, N = qweight.shape
    _check(x, {"qweight": (qweight, torch.int8),
               "scales": (scales, torch.float32)}, K, N)
    if tuple(scales.shape) != (N,):
        raise ValueError(f"scales {tuple(scales.shape)} != ({N},)")
    out = _launch("w8a16_launch", _W8_ARGS, x, K, N,
                  [qweight.data_ptr(), scales.data_ptr()],
                  [x.shape[0], K, N])
    _count(w8a16_matmul, x)
    return out


def fp8_matmul(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
               row_scales: torch.Tensor | None = None) -> torch.Tensor:
    """x [M, K] @ (e4m3fn [K, N] * scales [N]) -> [M, N] in x's dtype; with
    ``row_scales`` [M] fp32 (W8A8: x holds e4m3 values) each row of the
    fp32 sum is scaled by rs[m] before s[n].

    bf16 and fp16 run on ``w4_wgmma``'s "fp8" layout (M <= 256, K a
    multiple of 32, N of 16), fp32 on the CUDA-core kernel (N a multiple of
    4)."""
    if x.device.type == "cpu":
        return ref_fp8_matmul(x, qweight, scales, row_scales)
    if x.dtype in w4_wgmma.DTYPE_CODES:
        return _wgmma(fp8_matmul, "fp8", x, qweight, scales, None,
                      row_scales=row_scales)
    K, N = qweight.shape
    tensors = {"qweight": (qweight, torch.float8_e4m3fn),
               "scales": (scales, torch.float32)}
    if row_scales is not None:
        tensors["row_scales"] = (row_scales, torch.float32)
    _check(x, tensors, K, N)
    if tuple(scales.shape) != (N,) or (
            row_scales is not None
            and tuple(row_scales.shape) != (x.shape[0],)):
        raise ValueError(f"scales {tuple(scales.shape)} != ({N},) or row "
                         "scales not [M]")
    out = _launch("fp8_launch", _FP8_ARGS, x, K, N,
                  [qweight.data_ptr(), scales.data_ptr(),
                   None if row_scales is None else row_scales.data_ptr()],
                  [x.shape[0], K, N])
    _count(fp8_matmul, x)
    return out


def _w4_group(scales: torch.Tensor, zeros: torch.Tensor, K: int,
              N: int) -> int:
    G = scales.shape[0]
    if scales.dim() != 2 or tuple(scales.shape) != tuple(zeros.shape) \
            or scales.shape[1] != N or G < 1 or K % G:
        raise ValueError(f"scales/zeros {tuple(scales.shape)} / "
                         f"{tuple(zeros.shape)} do not fit K={K}, N={N}")
    return K // G


def w4a16_matmul(x: torch.Tensor, qweight: torch.Tensor,
                 scales: torch.Tensor, zeros: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ ((uint4-in-int8 [K, N] - z) * s) -> [M, N].

    bf16 and fp16 run on ``w4_wgmma`` (M <= 256, K and the group multiples
    of 32, N of 16), fp32 on the CUDA-core kernel (N a multiple of 4)."""
    if x.device.type == "cpu":
        return ref_w4a16_matmul(x, qweight, scales, zeros)
    if x.dtype in w4_wgmma.DTYPE_CODES:
        return _wgmma(w4a16_matmul, "uint4", x, qweight, scales, zeros)
    K, N = qweight.shape
    _check(x, {"qweight": (qweight, torch.int8),
               "scales": (scales, torch.float32),
               "zeros": (zeros, torch.float32)}, K, N)
    group = _w4_group(scales, zeros, K, N)
    out = _launch("w4a16_launch", _W4_ARGS, x, K, N,
                  [qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr()],
                  [x.shape[0], K, N, group])
    _count(w4a16_matmul, x)
    return out


def w4a16_packed_matmul(x: torch.Tensor, qpacked: torch.Tensor,
                        scales: torch.Tensor,
                        zeros: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(uint8 [K/2, N] global-half packed) -> [M, N].

    bf16 and fp16 run on ``w4_wgmma`` (M <= 256, K and the group multiples
    of 32, N of 16), fp32 on the CUDA-core kernel (N a multiple of 4)."""
    if x.device.type == "cpu":
        return ref_w4a16_packed_matmul(x, qpacked, scales, zeros)
    if x.dtype in w4_wgmma.DTYPE_CODES:
        return _wgmma(w4a16_packed_matmul, "packed", x, qpacked, scales,
                      zeros)
    Kh, N = qpacked.shape
    K = 2 * Kh
    _check(x, {"qpacked": (qpacked, torch.uint8),
               "scales": (scales, torch.float32),
               "zeros": (zeros, torch.float32)}, K, N)
    group = _w4_group(scales, zeros, K, N)
    out = _launch("w4a16_packed_launch", _W4_ARGS, x, Kh, N,
                  [qpacked.data_ptr(), scales.data_ptr(), zeros.data_ptr()],
                  [x.shape[0], K, N, group])
    _count(w4a16_packed_matmul, x)
    return out


def w4a16_int4_matmul(x: torch.Tensor, q4p: torch.Tensor,
                      scales: torch.Tensor,
                      zeros: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ ((int4 [K, N] - z) * s) -> [M, N], q4 packed as uint8
    [K/2, N] (``pack_int4``), group-wise as the TPU ``_w4i4_kernel``.

    bf16 and fp16 run on ``w4_wgmma`` (M <= 256, K and the group multiples
    of 32, N of 16). fp32 runs on the CUDA-core kernel: blocks of up to 32
    rows of M and 128 columns, K split on group and 256-row boundaries until
    the card has about two blocks per SM; an even group that divides 256 or
    is a multiple of it."""
    if x.device.type == "cpu":
        return ref_w4a16_int4_matmul(x, q4p, scales, zeros)
    if x.dtype in w4_wgmma.DTYPE_CODES:
        return _wgmma(w4a16_int4_matmul, "int4", x, q4p, scales, zeros)
    Kh, N = q4p.shape
    K = 2 * Kh
    _check(x, {"qweight4": (q4p, torch.uint8),
               "scales": (scales, torch.float32),
               "zeros": (zeros, torch.float32)}, K, N)
    group = _w4_group(scales, zeros, K, N)
    if group % 2 or (_I4_TILE_K % group and group % _I4_TILE_K):
        raise ValueError(f"group {group} does not fit the fp32 int4 kernel "
                         f"(an even group dividing {_I4_TILE_K} or a "
                         "multiple of it)")
    M = x.shape[0]
    mt, splits, chunk = _plan(M, N, K, _I4_BLOCK_N, max(group, _I4_TILE_K),
                              x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    partial = counters = None
    if splits > 1:
        partial, counters = cuda_build.split_workspace(
            x.device, splits * M * N, cdiv(N, _I4_BLOCK_N) * cdiv(M, mt))
    fn = cuda_build.entry("quant_matmul", "w4a16_int4_launch", _W4I4_ARGS)
    err = fn(DTYPE_CODES[x.dtype], mt, x.data_ptr(), q4p.data_ptr(),
             scales.data_ptr(), zeros.data_ptr(), out.data_ptr(), partial,
             counters, M, K, N, group, splits, chunk,
             cuda_build.stream(x.device))
    cuda_build.check(err, f"quant_matmul w4a16_int4_launch M={M} K={K} "
                          f"N={N} group={group}")
    _count(w4a16_int4_matmul, x)
    return out


KERNELS = {"w8a16_matmul": w8a16_matmul, "w4a16_matmul": w4a16_matmul,
           "w4a16_packed_matmul": w4a16_packed_matmul,
           "w4a16_int4_matmul": w4a16_int4_matmul, "fp8_matmul": fp8_matmul}
# Launches of the CUDA kernels (a run sets them to 0 and reads them after),
# and the same by x's dtype: fp32 (the CUDA-core kernels), bf16 and fp16
# (``w4_wgmma``'s instances of that element type).
for _fn in KERNELS.values():
    _fn.launches = 0
    _fn.dtype_launches = {"float32": 0, "bfloat16": 0, "float16": 0}
