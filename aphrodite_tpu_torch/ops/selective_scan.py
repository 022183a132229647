"""Selective scan: the Mamba recurrence h[t] = dA[t] * h[t-1] + dBx[t].

``selective_scan(dA, dBx)`` has the contract of the JAX package's
``selective_scan`` / ``ssm_scan`` (``aphrodite_tpu/ops/selective_scan.py``):
the scan runs along axis 0 from h[-1] = 0, the trailing dims are columns,
the inputs are taken as fp32 and the result is fp32 with the input shape.
On CUDA tensors it launches the hand-written kernel of
``csrc/selective_scan.cu`` at every T, one-token decode steps included (the
JAX package takes XLA's ``associative_scan`` below T = 64: a choice about
XLA dispatch, not about results). On CPU tensors it runs the plain PyTorch
version ``ref_selective_scan``, the recurrence as defined, one row at a
time.

Segments need no support here: the caller zeroes dA at each segment's
first token and folds the resumed state into dBx (``models/mamba.py``).
"""
from __future__ import annotations

import ctypes

import torch

from aphrodite_tpu_torch.ops import cuda_build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_void_p]


def _columns(dA: torch.Tensor, dBx: torch.Tensor):
    if dA.shape != dBx.shape or dA.dim() < 1:
        raise ValueError(f"dA and dBx must share one shape [T, ...], got "
                         f"{tuple(dA.shape)} and {tuple(dBx.shape)}")
    T, C = dA.shape[0], 1
    for d in dA.shape[1:]:
        C *= d
    a = dA.float().reshape(T, C)
    b = dBx.float().reshape(T, C)
    return a, b


def ref_selective_scan(dA: torch.Tensor, dBx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a loop over T, a product then a sum (each
    rounded) per row, as the kernel computes it."""
    a, b = _columns(dA, dBx)
    out = torch.empty_like(a)
    h = torch.zeros_like(a[0]) if a.shape[0] else None
    for t in range(a.shape[0]):
        h = a[t] * h + b[t]
        out[t] = h
    return out.reshape(dA.shape)


def selective_scan(dA: torch.Tensor, dBx: torch.Tensor) -> torch.Tensor:
    """hs[t] = dA[t] * hs[t-1] + dBx[t] over axis 0, hs[-1] = 0; dA and dBx
    of one shape [T, ...]; returns fp32 hs of that shape."""
    if dA.device.type == "cpu":
        return ref_selective_scan(dA, dBx)
    a, b = _columns(dA, dBx)
    if b.device != a.device:
        raise ValueError(f"dA on {a.device}, dBx on {b.device}")
    a, b = a.contiguous(), b.contiguous()
    T, C = a.shape
    out = torch.empty((T, C), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out.reshape(dA.shape)
    fn = cuda_build.entry("selective_scan", "selective_scan_launch",
                          _ARGTYPES)
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), T, C,
             cuda_build.stream(a.device))
    cuda_build.check(err, "selective_scan")
    selective_scan.launches += 1
    return out.reshape(dA.shape)


# Launches of the CUDA kernel (a run sets it to 0 and reads it after).
selective_scan.launches = 0
