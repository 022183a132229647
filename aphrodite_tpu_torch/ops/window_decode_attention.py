"""Window decode attention: one query per request over a frozen paged
cache plus the window's tail.

``window_decode_attention`` launches the hand-written CUDA kernel
(``csrc/window_decode_attention.cu``, which replaces the TPU kernel
``aphrodite_tpu/ops/window_decode_attention.py:_wd_kernel``) on CUDA
tensors, and runs the plain PyTorch version ``ref_window_decode_attention``
on CPU tensors. Request r's query sits at position paged_lens[r] + step; it
attends to page positions < paged_lens[r] and to tail slots j <= step.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops.ragged_paged_attention import DTYPE_CODES

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _I, _F, _I, _I, _F, _I, _I, _P]
_TILE = 32  # keys per warp tile


def window_smem_bytes(group: int, hd: int, warps: int) -> int:
    """Shared memory of one launch (the kernel's layout): q [group, hd],
    then per warp a K tile [32, hd + 1], a V tile [32, hd], p [32], acc
    [group, hd], m and l [group], all fp32."""
    per_warp = _TILE * (2 * hd + 2) + group * hd + 2 * group
    return 4 * (group * hd + warps * per_warp)


def window_warps(group: int, hd: int, smem_limit: int) -> int:
    """Warps per block: 4, else 2, else 1, the first whose tiles fit the
    card's shared memory (2 at head_dim 256); raises when none fits."""
    return cuda_build.fit_warps(
        f"window_decode_attention (group {group}, head_dim {hd})",
        lambda warps: window_smem_bytes(group, hd, warps), smem_limit)


def ref_window_decode_attention(
    q: torch.Tensor,            # [R, nq, hd]
    cache_layer: torch.Tensor,  # [P, 2, kvh, page, hd]
    tail_k_l: torch.Tensor,     # [R, kvh, Kw, hd] (layer slice)
    tail_v_l: torch.Tensor,
    step: int,
    paged_lens: torch.Tensor,   # [R]
    block_tables: torch.Tensor,  # [R, max_pages]
    scale: float,
    sliding_window: Optional[int] = None,
    chunk_attn: Optional[int] = None,
    logits_soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version, in fp32 (CPU path and the kernel's yardstick
    of correctness)."""
    _, _, kvh, page, hd = cache_layer.shape
    R, nq, _ = q.shape
    group = nq // kvh
    max_kv = block_tables.shape[1] * page
    Kw = tail_k_l.shape[2]
    kv = cache_layer[block_tables.long()]     # [R, MP, 2, kvh, page, hd]
    kv = kv.permute(0, 2, 3, 1, 4, 5).reshape(R, 2, kvh, max_kv, hd)
    keys = torch.cat([kv[:, 0], tail_k_l], dim=2).float()   # [R,kvh,K+,hd]
    values = torch.cat([kv[:, 1], tail_v_l], dim=2).float()
    qf = q.float().reshape(R, kvh, group, hd)
    logits = torch.einsum("rhgd,rhkd->rhgk", qf, keys) * scale
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    plen = paged_lens.long()[:, None]
    pos = plen + step
    j = torch.arange(Kw, device=q.device)[None, :]
    kv_pos = torch.cat([
        torch.arange(max_kv, device=q.device)[None, :].expand(R, max_kv),
        plen + j], dim=1)
    mask = torch.cat([kv_pos[:, :max_kv] < plen,
                      (j <= step).expand(R, Kw)], dim=1)
    if sliding_window is not None:
        mask &= kv_pos > pos - sliding_window
    if chunk_attn is not None:
        mask &= (kv_pos // chunk_attn) == (pos // chunk_attn)
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1).nan_to_num(0.0)
    out = torch.einsum("rhgk,rhkd->rhgd", probs, values)
    return out.reshape(R, nq, hd).to(q.dtype)


def window_decode_attention(
    q: torch.Tensor,          # [R, nq, hd]
    kv_cache: torch.Tensor,   # [L, P, 2, kvh, page, hd] (frozen)
    tail_k: torch.Tensor,     # [L, R, kvh, Kw, hd]
    tail_v: torch.Tensor,
    layer: int,
    step: int,
    paged_lens: torch.Tensor,   # [R] int32
    block_tables: torch.Tensor,  # [R, max_pages] int32
    scale: float,
    sliding_window: Optional[int] = None,
    chunk_attn: Optional[int] = None,
    logits_soft_cap: Optional[float] = None,
    cascade_init=None,
    shared_len=None,
) -> torch.Tensor:
    """Attention output [R, nq, hd] in q's dtype. The kernel reads the
    layer's cache and tails through base pointers: nothing is copied."""
    if cascade_init is not None or shared_len is not None:
        raise NotImplementedError(
            "cascade (shared-prefix) init state is not ported yet")
    if kv_cache.dtype != q.dtype or tail_k.dtype != q.dtype:
        raise NotImplementedError(
            "cache, tails and query must share one dtype (an fp8 cache is "
            "not ported yet)")
    if q.device.type == "cpu":
        return ref_window_decode_attention(
            q, kv_cache[layer], tail_k[layer], tail_v[layer], step,
            paged_lens, block_tables, scale, sliding_window=sliding_window,
            chunk_attn=chunk_attn, logits_soft_cap=logits_soft_cap)
    if not q.is_cuda or q.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported query tensor: {q.device} {q.dtype}")
    for t in (q, kv_cache, tail_k, tail_v):
        if not t.is_contiguous():
            raise ValueError("q, cache and tails must be contiguous")
    R, nq, hd = q.shape
    _, _, _, kvh, page, hd_c = kv_cache.shape
    Kw = tail_k.shape[3]
    if hd_c != hd or nq % kvh or tuple(tail_k.shape[1:]) != (R, kvh, Kw, hd):
        raise ValueError(f"bad geometry: q {tuple(q.shape)} cache "
                         f"{tuple(kv_cache.shape)} tail "
                         f"{tuple(tail_k.shape)}")
    if not 0 <= step < Kw:
        raise ValueError(f"step {step} outside the tail of {Kw} slots")
    for t in (paged_lens, block_tables):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError("metadata must be contiguous int32 on q's "
                             "device")
    out = torch.empty_like(q)
    warps = window_warps(nq // kvh, hd, cuda_build.smem_optin())
    launch = cuda_build.entry("window_decode_attention", "wd_launch",
                              _ARGTYPES)
    err = launch(
        DTYPE_CODES[q.dtype], q.data_ptr(), kv_cache[layer].data_ptr(),
        tail_k[layer].data_ptr(), tail_v[layer].data_ptr(), out.data_ptr(),
        paged_lens.data_ptr(), block_tables.data_ptr(), R,
        block_tables.shape[1], nq, kvh, page, hd, Kw, step, scale,
        sliding_window or 0, chunk_attn or 0, logits_soft_cap or 0.0, warps,
        window_smem_bytes(nq // kvh, hd, warps), cuda_build.stream(q.device))
    cuda_build.check(err, "window_decode_attention launch")
    window_decode_attention.launches += 1
    return out


# Launches of the CUDA kernel (a run sets it to 0 and reads it after).
window_decode_attention.launches = 0
