"""Grouped GEMM over rows sorted by group: the sparse-MoE expert product.

``grouped_matmul(x, w, group_offsets)`` computes, for every group e,
``y[off[e]:off[e+1]] = x[off[e]:off[e+1]] @ w[e]`` with fp32 sums and one
rounding to x's dtype at the end, which is what the JAX package's
``gmm(..., preferred_element_type=f32).astype(h.dtype)`` gives. On CUDA
tensors it launches the hand-written kernel of ``csrc/grouped_matmul.cu``
(which replaces the megablox ``gmm`` TPU kernel that
``aphrodite_tpu/models/moe_common.py`` calls); on CPU tensors it runs the
plain PyTorch version ``ref_grouped_matmul``. The kernel reads the group
offsets on the device: the host never learns the group sizes, so a launch
does not wait for the card.
"""
from __future__ import annotations

import ctypes

import torch

from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops.ragged_paged_attention import DTYPE_CODES

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P]


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
    [off[e], off[e + 1]); off[0] = 0, nondecreasing, off[E] = M. fp32 and
    bf16; the bf16 kernel needs K and N multiples of 8."""
    if x.device.type == "cpu":
        return ref_grouped_matmul(x, w, group_offsets)
    M, K = x.shape
    E, Kw, N = w.shape
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype or Kw != K:
        raise ValueError(f"want x [M, K] and w [E, K, N] of one dtype "
                         f"(fp32 or bf16), got {x.dtype} {tuple(x.shape)} "
                         f"and {w.dtype} {tuple(w.shape)}")
    if x.dtype == torch.bfloat16 and (K % 8 or N % 8):
        raise ValueError(f"bf16 needs K ({K}) and N ({N}) to be multiples "
                         "of 8")
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
    fn = cuda_build.entry("grouped_matmul", "grouped_matmul_launch",
                          _ARGTYPES)
    err = fn(DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
             group_offsets.data_ptr(), out.data_ptr(), M, K, N, E,
             cuda_build.stream(x.device))
    cuda_build.check(err, "grouped_matmul")
    grouped_matmul.launches += 1
    return out


# Launches of the CUDA kernel (a run sets it to 0 and reads it after).
grouped_matmul.launches = 0
