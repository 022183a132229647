"""Cascade (shared-prefix) attention for the decode window.

When every request of a decode window holds the same leading KV pages
(prefix caching dedups them physically), the shared prefix is attended
once for the whole batch each sub-step, one pass of all R * group query
rows of each KV head over the shared tokens, and the window decode kernel
starts each request from that pass's unnormalized online-softmax state
(``window_decode_attention(..., cascade_init=...)``), reading only the keys
past the prefix. Causality is free: every query sits past the prefix.

``shared_prefix_attention`` launches the hand-written CUDA kernel
(``csrc/shared_prefix_attention.cu``, which replaces the TPU kernel
``aphrodite_tpu/ops/cascade_attention.py:shared_prefix_attention`` /
``_spa_kernel``) on CUDA tensors, and runs the plain PyTorch version
``ref_shared_prefix_attention`` on CPU tensors. The state it returns is
fp32 ``acc [R, kvh, group, hd]`` and ``m, l [R, kvh, group]`` (the TPU
kernel's 128-lane widening of m and l is not copied). A row with no shared
token gets m = -inf, l = 0 and acc = 0.
"""
from __future__ import annotations

import ctypes

import torch

from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops.ragged_paged_attention import DTYPE_CODES
from aphrodite_tpu_torch.ops.window_decode_attention import (
    ref_window_decode_attention)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
             _P]
_TILE = 32         # keys staged at a time
_ROWS = 32         # query rows a block (8 warps of 4)


def spa_smem_bytes(hd: int) -> int:
    """Shared memory of one launch (the kernel's layout, all fp32): the
    block's q rows [32, hd], K transposed [hd, 33], V [32, hd + 1], and p
    [8 warps, 4 rows, 32]."""
    return 4 * (_ROWS * hd + hd * (_TILE + 1) + _TILE * (hd + 1)
                + _ROWS * _TILE)


def ref_shared_prefix_attention(
    q: torch.Tensor,             # [R, nq, hd]
    cache_layer: torch.Tensor,   # [P, 2, kvh, page, hd]
    shared_pages: torch.Tensor,  # [n] int32 physical page ids
    shared_len: int,             # tokens of the prefix, <= n * page
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, in fp32: (acc unnormalized, m, l)."""
    _, _, kvh, page, hd = cache_layer.shape
    R, nq, _ = q.shape
    group = nq // kvh
    kv = cache_layer[shared_pages.long()]            # [n, 2, kvh, page, hd]
    kv = kv.permute(1, 2, 0, 3, 4).reshape(2, kvh, -1, hd).float()
    keys, values = kv[0], kv[1]                      # [kvh, n * page, hd]
    qf = q.float().reshape(R, kvh, group, hd)
    s = torch.einsum("rhgd,hkd->rhgk", qf, keys) * scale
    valid = torch.arange(keys.shape[1], device=q.device) < shared_len
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])             # masked keys: 0
    return (torch.einsum("rhgk,hkd->rhgd", p, values), m, p.sum(dim=-1))


def ref_cascade_window_decode(
    q: torch.Tensor, cache_layer: torch.Tensor, tail_k_l: torch.Tensor,
    tail_v_l: torch.Tensor, step: int, paged_lens: torch.Tensor,
    block_tables: torch.Tensor, shared_pages: torch.Tensor, shared_len: int,
    scale: float) -> torch.Tensor:
    """The cascade split in plain PyTorch (the JAX package's oracle of the
    same name): the shared-prefix state, then the window attention over
    the keys past the prefix started from it. Equals the plain window
    attention over the whole context."""
    init = ref_shared_prefix_attention(q, cache_layer, shared_pages,
                                       shared_len, scale)
    return ref_window_decode_attention(
        q, cache_layer, tail_k_l, tail_v_l, step, paged_lens, block_tables,
        scale, cascade_init=init, shared_len=shared_len)


def shared_prefix_attention(
    q: torch.Tensor,             # [R, nq, hd]
    kv_cache: torch.Tensor,      # [L, P, 2, kvh, page, hd] (frozen)
    layer: int,
    shared_pages: torch.Tensor,  # [n] int32
    shared_len: int,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The shared prefix's online-softmax state for every request's query:
    (acc [R, kvh, group, hd], m [R, kvh, group], l [R, kvh, group]), fp32,
    reading the shared pages once. The kernel reads the layer's cache
    through its base pointer: nothing is copied."""
    R, nq, hd = q.shape
    _, _, _, kvh, page, hd_c = kv_cache.shape
    if hd_c != hd or nq % kvh:
        raise ValueError(f"bad geometry: q {tuple(q.shape)} cache "
                         f"{tuple(kv_cache.shape)}")
    if not 0 <= shared_len <= shared_pages.numel() * page:
        raise ValueError(f"shared_len {shared_len} outside the "
                         f"{shared_pages.numel()} shared pages of {page}")
    if kv_cache.dtype != q.dtype:
        raise NotImplementedError(
            "cache and query must share one dtype (an fp8 cache is not "
            "ported yet)")
    if q.device.type == "cpu":
        return ref_shared_prefix_attention(q, kv_cache[layer], shared_pages,
                                           shared_len, scale)
    if not q.is_cuda or q.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported query tensor: {q.device} {q.dtype}")
    if hd not in (64, 128, 256):
        raise ValueError(f"head_dim {hd}: the kernel takes 64, 128 or 256")
    if not (q.is_contiguous() and kv_cache.is_contiguous()):
        raise ValueError("q and cache must be contiguous")
    if shared_pages.dtype != torch.int32 or not shared_pages.is_contiguous() \
            or shared_pages.device != q.device:
        raise ValueError("shared_pages must be contiguous int32 on q's "
                         "device")
    group = nq // kvh
    acc = torch.empty((R, kvh, group, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.empty((R, kvh, group), dtype=torch.float32, device=q.device)
    lsum = torch.empty_like(m)
    smem = spa_smem_bytes(hd)
    cuda_build.check_smem("shared_prefix_attention", smem,
                          cuda_build.smem_optin())
    launch = cuda_build.entry("shared_prefix_attention", "spa_launch",
                              _ARGTYPES)
    err = launch(
        DTYPE_CODES[q.dtype], q.data_ptr(), kv_cache[layer].data_ptr(),
        shared_pages.data_ptr(), shared_len, acc.data_ptr(), m.data_ptr(),
        lsum.data_ptr(), R, nq, kvh, page, hd, scale, smem,
        cuda_build.stream(q.device))
    cuda_build.check(err, "shared_prefix_attention launch")
    shared_prefix_attention.launches += 1
    return acc, m, lsum


# Launches of the CUDA kernel (a run sets it to 0 and reads it after).
shared_prefix_attention.launches = 0
