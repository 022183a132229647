"""Weight-only quantized GEMMs for decode-sized M: y = x @ dequant(W).

Three wrappers launch the hand-written CUDA kernels of
``csrc/quant_matmul.cu`` on CUDA tensors, each replacing one TPU kernel of
``aphrodite_tpu/ops/quant_matmul_pallas.py``:

- ``w8a16_matmul`` (``w8a16_matmul_pallas``): int8 [K, N] times fp32
  per-column scales [N];
- ``w4a16_matmul`` (``w4a16_matmul_pallas``): uint4 held in int8 [K, N],
  ``W = (q - z) * s`` with fp32 scales and zeros [K/group, N];
- ``w4a16_packed_matmul`` (``w4a16_packed_matmul_pallas``): the same W
  from uint8 [K/2, N], byte [r, n] holding row r in its low nibble and row
  r + K/2 in its high nibble.

On CPU tensors each runs its plain PyTorch version (``ref_*``), which
dequantizes W in fp32 with the direct form ``(q - z) * s``, as the kernels
do in registers; a CUDA tensor launches the kernel or raises. x and y are
fp32 or bf16, sums fp32: bf16 runs on the tensor cores (``mma.sync``,
weights rounded to bf16 after the fp32 dequantize), fp32 on the CUDA cores
in fp32 throughout. Each wrapper counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops.ragged_paged_attention import DTYPE_CODES
from aphrodite_tpu_torch.utils import cdiv

_P, _I = ctypes.c_void_p, ctypes.c_int
_W8_ARGS = [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_W4_ARGS = [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            _P]
# (columns per block, split granularity in stored rows) of the CUDA-core
# kernel (kBlockN, kTileK) and of the tensor-core one (kTcBlockN, kTcTileK).
_GRID = {False: (128, 128), True: (128, 256)}
_PLANS: dict[tuple, tuple[int, int, int]] = {}
_BLOCKS_PER_SM = 2   # K splits are added until the grid has this many
# Per device: fp32 partial sums and the kernels' split counters (zero
# between launches: the last block of a tile resets its counter).
_WORKSPACE: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


# ---------------------------------------------------------------- plain twins
def unpack_w4(qpacked: torch.Tensor) -> torch.Tensor:
    """uint8 [K/2, N] -> uint4-in-int8 [K, N] (inverse of ``pack_w4``)."""
    p = qpacked.to(torch.int16)
    return torch.cat([p & 0xF, (p >> 4) & 0xF], dim=0).to(torch.int8)


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


def ref_w4a16_matmul(x: torch.Tensor, qweight: torch.Tensor,
                     scales: torch.Tensor,
                     zeros: torch.Tensor) -> torch.Tensor:
    return (x.float() @ dequant_w4(qweight, scales, zeros)).to(x.dtype)


def ref_w4a16_packed_matmul(x: torch.Tensor, qpacked: torch.Tensor,
                            scales: torch.Tensor,
                            zeros: torch.Tensor) -> torch.Tensor:
    return ref_w4a16_matmul(x, unpack_w4(qpacked), scales, zeros)


# -------------------------------------------------------------------- launch
def _plan(M: int, N: int, rows: int, tc: bool, device: torch.device
          ) -> tuple[int, int, int]:
    """(MT, splits, chunk): rows of M per block, K splits, and stored
    weight rows per split. Splits are added until the grid has about two
    blocks per SM (N = 4096 alone gives 16-32 column blocks)."""
    key = (M, N, rows, tc, device.index)
    plan = _PLANS.get(key)
    if plan is None:
        mt = 8 if M <= 8 else 16 if M <= 16 else 32
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        block_n, unit = _GRID[tc]
        blocks = cdiv(N, block_n) * cdiv(M, mt)
        units = cdiv(rows, unit)
        want = max(1, min(units, cdiv(_BLOCKS_PER_SM * sms, blocks)))
        per = cdiv(units, want)
        plan = _PLANS[key] = (mt, cdiv(units, per), per * unit)
    return plan


def _check(x: torch.Tensor, tensors: dict, K: int, N: int) -> None:
    if x.dtype not in DTYPE_CODES or x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"x must be fp32/bf16 [M, {K}], got "
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


def _workspace(device: torch.device, floats: int, tiles: int
               ) -> tuple[int, int]:
    """Pointers to ``floats`` fp32 of scratch and ``tiles`` zeroed int32
    counters on ``device``, grown as needed and reused by every launch
    (launches on one stream run one after the other)."""
    partial, counters = _WORKSPACE.get(device.index, (None, None))
    if partial is None or partial.numel() < floats:
        partial = torch.empty(max(floats, 1 << 20), dtype=torch.float32,
                              device=device)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(max(tiles, 4096), dtype=torch.int32,
                               device=device)
    _WORKSPACE[device.index] = (partial, counters)
    return partial.data_ptr(), counters.data_ptr()


def _launch(symbol: str, argtypes: list, x: torch.Tensor, rows: int,
            N: int, group: int, ptrs: list, dims: list) -> torch.Tensor:
    """Call ``symbol(dtype, mt, tc, x, *ptrs, out, partial, counters,
    *dims, splits, chunk, stream)``; ``rows`` is the number of stored
    weight rows. bf16 runs on the tensor-core kernel, which loads 32 rows
    at a time, so K and the group must be multiples of 32; fp32 runs on
    the CUDA-core one."""
    M, K = x.shape
    tc = x.dtype == torch.bfloat16
    if tc and (K % 32 or group % 32):
        raise ValueError(f"bf16 needs K ({K}) and the group ({group}) to be "
                         "multiples of 32")
    mt, splits, chunk = _plan(M, N, rows, tc, x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    partial = counters = None
    if splits > 1:
        tiles = cdiv(N, _GRID[tc][0]) * cdiv(M, mt)
        partial, counters = _workspace(x.device, splits * M * N, tiles)
    fn = cuda_build.entry("quant_matmul", symbol, argtypes)
    err = fn(DTYPE_CODES[x.dtype], mt, int(tc), x.data_ptr(), *ptrs,
             out.data_ptr(), partial, counters, *dims, splits, chunk,
             cuda_build.stream(x.device))
    cuda_build.check(err, f"quant_matmul {symbol}")
    return out


def w8a16_matmul(x: torch.Tensor, qweight: torch.Tensor,
                 scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ (int8 [K, N] * scales [N]) -> [M, N] in x's dtype."""
    if x.device.type == "cpu":
        return ref_w8a16_matmul(x, qweight, scales)
    K, N = qweight.shape
    _check(x, {"qweight": (qweight, torch.int8),
               "scales": (scales, torch.float32)}, K, N)
    if tuple(scales.shape) != (N,):
        raise ValueError(f"scales {tuple(scales.shape)} != ({N},)")
    out = _launch("w8a16_launch", _W8_ARGS, x, K, N, 32,
                  [qweight.data_ptr(), scales.data_ptr()],
                  [x.shape[0], K, N])
    w8a16_matmul.launches += 1
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
    """x [M, K] @ ((uint4-in-int8 [K, N] - z) * s) -> [M, N]."""
    if x.device.type == "cpu":
        return ref_w4a16_matmul(x, qweight, scales, zeros)
    K, N = qweight.shape
    _check(x, {"qweight": (qweight, torch.int8),
               "scales": (scales, torch.float32),
               "zeros": (zeros, torch.float32)}, K, N)
    group = _w4_group(scales, zeros, K, N)
    out = _launch("w4a16_launch", _W4_ARGS, x, K, N, group,
                  [qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr()],
                  [x.shape[0], K, N, group])
    w4a16_matmul.launches += 1
    return out


def w4a16_packed_matmul(x: torch.Tensor, qpacked: torch.Tensor,
                        scales: torch.Tensor,
                        zeros: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(uint8 [K/2, N] global-half packed) -> [M, N]."""
    if x.device.type == "cpu":
        return ref_w4a16_packed_matmul(x, qpacked, scales, zeros)
    Kh, N = qpacked.shape
    K = 2 * Kh
    _check(x, {"qpacked": (qpacked, torch.uint8),
               "scales": (scales, torch.float32),
               "zeros": (zeros, torch.float32)}, K, N)
    group = _w4_group(scales, zeros, K, N)
    out = _launch("w4a16_packed_launch", _W4_ARGS, x, Kh, N, group,
                  [qpacked.data_ptr(), scales.data_ptr(), zeros.data_ptr()],
                  [x.shape[0], K, N, group])
    w4a16_packed_matmul.launches += 1
    return out


# Launches of the CUDA kernels (a run sets them to 0 and reads them after).
w8a16_matmul.launches = 0
w4a16_matmul.launches = 0
w4a16_packed_matmul.launches = 0

KERNELS = {"w8a16_matmul": w8a16_matmul, "w4a16_matmul": w4a16_matmul,
           "w4a16_packed_matmul": w4a16_packed_matmul}
