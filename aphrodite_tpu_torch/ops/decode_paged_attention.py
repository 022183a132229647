"""Decode paged attention: one query token per request over the paged cache.

``decode_paged_attention`` launches the hand-written CUDA kernel
(``csrc/decode_paged_attention.cu``, which replaces the TPU kernel
``aphrodite_tpu/ops/decode_paged_attention.py:_decode_kernel``) on CUDA
tensors, and runs the plain PyTorch version ``ref_decode_paged_attention``
on CPU tensors. Request r's query sits at position seq_lens[r] - 1, whose
K/V the step has already written; it attends the request's positions
0..seq_lens[r] - 1. The runner's non-window multi-step decode
(``worker/runner.py: _execute_multi_step``) is its caller.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops.ragged_paged_attention import DTYPE_CODES

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I,
             _F, _I, _I, _P]
_TILE = 32  # keys per warp tile


def decode_smem_bytes(group: int, hd: int, itemsize: int, warps: int) -> int:
    """Shared memory of one launch (the kernel's layout): q [group, hd]
    fp32, then per warp a K tile of 32 rows padded by one 32-bit word, a V
    tile (both in the cache's dtype), p [32], acc [group, hd], m and l
    [group] in fp32."""
    words = hd * itemsize // 4
    per_warp = _TILE * (2 * words + 1) + _TILE + group * hd + 2 * group
    return 4 * (group * hd + warps * per_warp)


def decode_warps(group: int, hd: int, itemsize: int, smem_limit: int) -> int:
    """Warps per block: 4, else 2, else 1, the first whose tiles fit the
    card's shared memory (fp32 at head_dim 256: 2); raises when none
    fits."""
    return cuda_build.fit_warps(
        f"decode_paged_attention (group {group}, head_dim {hd})",
        lambda warps: decode_smem_bytes(group, hd, itemsize, warps),
        smem_limit)


def ref_decode_paged_attention(
    q: torch.Tensor,             # [R, nq, hd]
    cache_layer: torch.Tensor,   # [P, 2, kvh, page, hd]
    block_tables: torch.Tensor,  # [R, max_pages]
    seq_lens: torch.Tensor,      # [R]
    scale: float,
    sliding_window: Optional[int] = None,
    chunk_attn: Optional[int] = None,
    logits_soft_cap: Optional[float] = None,
    alibi: Optional[torch.Tensor] = None,  # [nq] fp32 slopes
) -> torch.Tensor:
    """Plain PyTorch version, in fp32 (CPU path and the kernel's yardstick
    of correctness): each request's pages gathered, one masked softmax per
    query row. ALiBi is added before the soft cap, as the TPU kernel adds
    it. Rows with seq_len 0, and fully masked rows, give 0."""
    _, _, kvh, page, hd = cache_layer.shape
    R, nq, _ = q.shape
    group = nq // kvh
    max_kv = block_tables.shape[1] * page
    kv = cache_layer[block_tables.long()]     # [R, MP, 2, kvh, page, hd]
    kv = kv.permute(0, 2, 3, 1, 4, 5).reshape(R, 2, kvh, max_kv, hd).float()
    qf = q.float().reshape(R, kvh, group, hd)
    logits = torch.einsum("rhgd,rhkd->rhgk", qf, kv[:, 0]) * scale
    pos = seq_lens.long()[:, None] - 1                       # [R, 1]
    kv_pos = torch.arange(max_kv, device=q.device)[None, :]  # [1, max_kv]
    if alibi is not None:
        slopes = alibi.float().reshape(kvh, group)
        logits = logits + (slopes[None, :, :, None]
                           * (kv_pos - pos).float()[:, None, None, :])
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    mask = kv_pos <= pos
    if sliding_window is not None:
        mask &= kv_pos > pos - sliding_window
    if chunk_attn is not None:
        mask &= (kv_pos // chunk_attn) == (pos // chunk_attn)
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1).nan_to_num(0.0)
    out = torch.einsum("rhgk,rhkd->rhgd", probs, kv[:, 1])
    return out.reshape(R, nq, hd).to(q.dtype)


def decode_paged_attention(
    q: torch.Tensor,             # [R, nq, hd]
    kv_cache: torch.Tensor,      # [L, P, 2, kvh, page, hd]
    layer: int,
    block_tables: torch.Tensor,  # [R, max_pages] int32
    seq_lens: torch.Tensor,      # [R] int32
    scale: float,
    sliding_window: Optional[int] = None,
    chunk_attn: Optional[int] = None,
    logits_soft_cap: Optional[float] = None,
    alibi: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention output [R, nq, hd] in q's dtype. ``alibi``: [nq] fp32
    slopes on q's device, or None. The kernel reads the layer through its
    base pointer in the full cache: nothing is copied."""
    if kv_cache.dtype != q.dtype:
        raise NotImplementedError(
            f"KV cache dtype {kv_cache.dtype} != query dtype {q.dtype} "
            "(an fp8 cache is not ported yet)")
    cache_layer = kv_cache[layer]
    if q.device.type == "cpu":
        return ref_decode_paged_attention(
            q, cache_layer, block_tables, seq_lens, scale,
            sliding_window=sliding_window, chunk_attn=chunk_attn,
            logits_soft_cap=logits_soft_cap, alibi=alibi)
    if not q.is_cuda or q.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported query tensor: {q.device} {q.dtype}")
    if not (q.is_contiguous() and kv_cache.is_contiguous()):
        raise ValueError("q and the KV cache must be contiguous")
    R, nq, hd = q.shape
    _, _, kvh, page, hd_c = cache_layer.shape
    if hd_c != hd or nq % kvh or (hd * q.element_size()) % 4:
        raise ValueError(f"bad geometry: q {tuple(q.shape)} cache "
                         f"{tuple(cache_layer.shape)}")
    for t in (seq_lens, block_tables):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError("metadata must be contiguous int32 on q's "
                             "device")
    if alibi is not None and (alibi.dtype != torch.float32
                              or alibi.shape != (nq,)
                              or not alibi.is_contiguous()
                              or alibi.device != q.device):
        raise ValueError("alibi must be contiguous [nq] float32 on q's "
                         "device")
    out = torch.empty_like(q)
    if R == 0:
        return out
    group = nq // kvh
    warps = decode_warps(group, hd, q.element_size(), cuda_build.smem_optin())
    launch = cuda_build.entry("decode_paged_attention", "dpa_launch",
                              _ARGTYPES)
    err = launch(
        DTYPE_CODES[q.dtype], q.data_ptr(), cache_layer.data_ptr(),
        out.data_ptr(), seq_lens.data_ptr(), block_tables.data_ptr(),
        alibi.data_ptr() if alibi is not None else None, R,
        block_tables.shape[1], nq, kvh, page, hd, scale, sliding_window or 0,
        chunk_attn or 0, logits_soft_cap or 0.0, warps,
        decode_smem_bytes(group, hd, q.element_size(), warps),
        cuda_build.stream(q.device))
    cuda_build.check(err, "decode_paged_attention launch")
    decode_paged_attention.launches += 1
    return out


# Launches of the CUDA kernel (a run sets it to 0 and reads it after).
decode_paged_attention.launches = 0
