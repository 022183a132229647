"""Grouped GEMM over rows sorted by group: the sparse-MoE expert product.

``grouped_matmul(x, w, group_offsets)`` computes, for every group e,
``y[off[e]:off[e+1]] = x[off[e]:off[e+1]] @ w[e]`` with fp32 sums and one
rounding to x's dtype at the end, which is what the JAX package's
``gmm(..., preferred_element_type=f32).astype(h.dtype)`` gives. On CUDA
tensors it launches the hand-written kernels of ``csrc/grouped_matmul.cu``
(which replace the megablox ``gmm`` TPU kernel,
``jax/experimental/pallas/ops/tpu/megablox/gmm.py:314``, that
``aphrodite_tpu/models/moe_common.py`` calls); on CPU tensors it runs the
plain PyTorch version ``ref_grouped_matmul``. The kernels read the group
offsets on the device: the host never learns the group sizes, so a launch
does not wait for the card.

At the MoE prefill wave the product is bound by the tensor cores' bf16
and fp16 rate (a Qwen1.5-MoE-A2.7B layer's two GEMMs over 65536 rows:
1.15 ms at 989 TFLOP/s), which only ``wgmma`` reaches. So the bf16 and
fp16 kernel (one source, ``csrc/grouped_matmul.cuh``, x's element type a
template parameter; the fp16 instance built in
``csrc/grouped_matmul_f16.cu``, ``grouped_matmul_f16_launch``) is
persistent (one block an SM walks the output tiles) and warp-specialised:
a producer warp loads 128 x 64 slices of x and 64 x 256 slices of the
expert's w by TMA into a ring of shared-memory stages, and two consumer
warpgroups multiply them with ``wgmma`` and send y out by TMA stores. The
blocks run in clusters of two on consecutive items, which share each w
slice (one load, multicast to both) when the items are of one expert.
``grouped_schedule`` models the order in which the blocks visit the
tiles, with the kernel's own arithmetic, for the CPU tests;
``grouped_smem_bytes`` is its shared memory. fp32 keeps a CUDA-core
kernel for the parity paths. x's dtype goes to the kernels as the
attention kernels' code (fp32 0, bf16 1, fp16 2), and the wrapper counts
launches by dtype (``dtype_launches``) beside ``launches``.
"""
from __future__ import annotations

import ctypes

import torch

from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops.ragged_paged_attention import DTYPE_CODES

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]

# The wgmma kernel's tiles (csrc/grouped_matmul.cuh, kWg*): rows, columns and
# depth of a tile, stages of the ring, blocks of a cluster.
BM, BN, BK, STAGES, CLUSTER = 128, 256, 64, 3, 2
FIND_CHUNK = 32  # experts a find_item step covers (one a lane)


def grouped_smem_bytes(bm: int = BM, bn: int = BN, bk: int = BK,
                       stages: int = STAGES) -> int:
    """Dynamic shared memory of the wgmma kernel (bf16 and fp16 alike):
    the ring of x and w slices, the two consumers' 64 x bn slabs of y on
    their way out, a "full" and an "empty" barrier a stage, and up to 1024
    bytes to align the ring to the 128-byte swizzle's period."""
    return (stages * (bm * bk + bk * bn) * 2 + bm * bn * 2
            + 2 * stages * 8 + 1024)


def _find_item(off: list[int], E: int, M: int, bm: int, item: int):
    """``find_item`` of the kernel: (group, row_lo, row_hi) of work item
    ``item``, or None when it has no work. The kernel's warp walks the
    experts 32 at a time, a prefix sum of their row-tile counts over its
    lanes; the first expert whose running count passes ``item`` owns it."""
    base = 0
    for e0 in range(0, E, FIND_CHUNK):
        incl = 0
        for e in range(e0, min(e0 + FIND_CHUNK, E)):
            start = min(max(off[e], 0), M)
            end = min(max(off[e + 1], start), M)
            tiles = (end - 1) // bm - start // bm + 1 if end > start else 0
            incl += tiles
            if tiles and item < base + incl:
                tile = start // bm + item - base - (incl - tiles)
                return (e, max(tile * bm, start),
                        min(tile * bm + bm, end))
        base += incl
    return None


def grouped_schedule(offsets, M: int, E: int, N: int, bm: int = BM,
                     bn: int = BN, grid: int = cuda_build.H100_SMS):
    """The wgmma kernel's schedule, in its own arithmetic: for each of its
    persistent blocks, the (group, row_lo, row_hi, n0) tiles whose rows
    [row_lo, row_hi) and columns [n0, min(n0 + bn, N)) of y it writes, in
    order. Blocks come in clusters of two, at most max(1, grid // 2)
    clusters (the kernel launches fewer where fewer fit on the card at
    once). Cluster c takes the pair tiles u = c, c + clusters, ...: items
    2p and 2p + 1, p = u // n_tiles, at columns (u % n_tiles) * bn, one
    item a block; a cluster stops at the first pair whose item 2p has no
    work. The block of an odd last item's missing partner writes
    nothing."""
    off = [int(v) for v in offsets]
    n_tiles = -(-N // bn)
    items = -(-M // bm) + E - 1
    max_tiles = -(-items // CLUSTER) * n_tiles
    clusters = max(1, min(grid // CLUSTER, max_tiles))
    visits = [[] for _ in range(CLUSTER * clusters)]
    for cid in range(clusters):
        for u in range(cid, max_tiles, clusters):
            p = u // n_tiles
            pair = [_find_item(off, E, M, bm, CLUSTER * p + r)
                    for r in range(CLUSTER)]
            if pair[0] is None:
                break
            for r, found in enumerate(pair):
                if found is not None:
                    visits[CLUSTER * cid + r].append(
                        (*found, (u % n_tiles) * bn))
    return visits


def ref_grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                       group_offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a loop over the groups, each product in fp32
    and cast to x's dtype. Rows that no group covers stay zero."""
    off = group_offsets.tolist()
    out = x.new_zeros((x.shape[0], w.shape[2]))
    for e in range(w.shape[0]):
        a, b = off[e], off[e + 1]
        if b > a:
            out[a:b] = (x[a:b].float() @ w[e].float()).to(x.dtype)
    return out


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_offsets: torch.Tensor) -> torch.Tensor:
    """x [M, K] (rows sorted by group) @ w [E, K, N] -> [M, N] in x's dtype.

    ``group_offsets`` is int32 [E + 1]: group e owns rows
    [off[e], off[e + 1]); off[0] = 0, nondecreasing, off[E] = M. fp32,
    bf16 and fp16; the bf16 and fp16 kernel needs K and N multiples of 8
    (TMA's 16-byte row strides) and x and w on 16-byte boundaries, and
    raises otherwise."""
    if x.device.type == "cpu":
        return ref_grouped_matmul(x, w, group_offsets)
    M, K = x.shape
    E, Kw, N = w.shape
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype or Kw != K:
        raise ValueError(f"want x [M, K] and w [E, K, N] of one dtype "
                         f"(fp32, bf16 or fp16), got {x.dtype} "
                         f"{tuple(x.shape)} and {w.dtype} {tuple(w.shape)}")
    if x.dtype != torch.float32 and (K % 8 or N % 8):
        raise ValueError(f"{x.dtype} needs K ({K}) and N ({N}) to be "
                         "multiples of 8")
    if group_offsets.dtype != torch.int32 \
            or tuple(group_offsets.shape) != (E + 1,):
        raise ValueError(f"group_offsets must be int32 [{E + 1}], got "
                         f"{group_offsets.dtype} "
                         f"{tuple(group_offsets.shape)}")
    for name, t in (("x", x), ("w", w), ("group_offsets", group_offsets)):
        if t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned on {x.device}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    # The fp16 instance is a library of its own (built beside).
    fn = (cuda_build.entry("grouped_matmul_f16", "grouped_matmul_f16_launch",
                           _ARGTYPES) if x.dtype == torch.float16 else
          cuda_build.entry("grouped_matmul", "grouped_matmul_launch",
                           _ARGTYPES))
    err = fn(DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
             group_offsets.data_ptr(), out.data_ptr(), M, K, N, E,
             cuda_build.sm_count(x.device), cuda_build.stream(x.device))
    cuda_build.check(err, "grouped_matmul")
    grouped_matmul.launches += 1
    grouped_matmul.dtype_launches[str(x.dtype).removeprefix("torch.")] += 1
    return out


# Launches of the CUDA kernels (a run sets them to 0 and reads them
# after), in all and by x's dtype.
grouped_matmul.launches = 0
grouped_matmul.dtype_launches = {"float32": 0, "bfloat16": 0, "float16": 0}
