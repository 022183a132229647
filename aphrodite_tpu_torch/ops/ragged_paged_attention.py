"""Ragged paged attention for prefill and mixed waves.

``ragged_paged_attention`` launches the hand-written CUDA kernel
(``csrc/ragged_paged_attention.cu``, which replaces the TPU kernel
``aphrodite_tpu/ops/ragged_paged_attention.py:_rpa_kernel``) on CUDA
tensors, and runs the plain PyTorch version ``ref_ragged_paged_attention``
on CPU tensors. Query token i of request r at position p attends to the
request's KV positions j <= p, read through its block table from one layer
of the paged cache, optionally restricted by a sliding window or chunked
local attention, with an optional logit soft cap.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.ops import cuda_build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
             _I, _I, _F, _I, _I, _F, _I, _P]
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Keys per shared-memory tile and warps per block of the kernel.
_TILE, _WARPS = 32, 8
# Query rows (tokens x query heads of one KV head) per work item, at most.
_MAX_ROWS = 128


def ragged_smem_bytes(block_q: int, group: int, hd: int) -> int:
    """Shared memory of one launch (the kernel's layout): q and acc for
    block_q * group rows, their m and l, a K tile padded to hd + 1 floats,
    a V tile and the warps' probabilities, all fp32."""
    rows = block_q * group
    return 4 * (2 * rows * hd + 2 * rows + _TILE * (hd + 1) + _TILE * hd
                + _WARPS * _TILE)


def ragged_block_q(group: int, hd: int, smem_limit: int) -> int:
    """Tokens per work item: as many whole groups of query rows as fit both
    _MAX_ROWS and the card's shared memory, rows <= (limit/4 - 32(2hd+1)
    - 256) / (2hd+2): 128 rows at hd 128, 80 at hd 256. Raises, naming the
    bytes, when not even one token fits."""
    fit = ((smem_limit // 4 - _TILE * (2 * hd + 1) - _WARPS * _TILE)
           // (2 * hd + 2))
    block_q = max(1, min(_MAX_ROWS, fit) // group)
    cuda_build.check_smem(
        f"ragged_paged_attention (group {group}, head_dim {hd}, "
        f"{block_q} tokens a work item)",
        ragged_smem_bytes(block_q, group, hd), smem_limit)
    return block_q


def ref_ragged_paged_attention(
    q: torch.Tensor,            # [T, nq, hd]
    cache_layer: torch.Tensor,  # [P, 2, kvh, page, hd]
    md: AttentionMetadata,
    scale: float,
    sliding_window: Optional[int] = None,
    logits_soft_cap: Optional[float] = None,
    chunk_attn: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version (CPU path and the kernel's yardstick of
    correctness): per request, gather its pages and run a masked fp32
    softmax for its tokens."""
    _, _, kvh, page, hd = cache_layer.shape
    T, nq, _ = q.shape
    group = nq // kvh
    out = torch.zeros_like(q)
    max_kv = md.block_tables.shape[1] * page
    kv_pos = torch.arange(max_kv, device=q.device)
    for r in torch.unique(md.token_req_idx).tolist():
        idx = torch.nonzero(md.token_req_idx == r).flatten()
        kv = cache_layer[md.block_tables[r].long()]  # [MP, 2, kvh, page, hd]
        kv = kv.permute(1, 2, 0, 3, 4).reshape(2, kvh, max_kv, hd).float()
        qf = q[idx].float().reshape(len(idx), kvh, group, hd)
        logits = torch.einsum("thgd,hkd->thgk", qf, kv[0]) * scale
        if logits_soft_cap is not None:
            logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
        pos = md.token_pos[idx].long()[:, None]
        mask = kv_pos[None, :] <= pos
        if sliding_window is not None:
            mask &= kv_pos[None, :] > pos - sliding_window
        if chunk_attn is not None:
            mask &= (kv_pos[None, :] // chunk_attn) == (pos // chunk_attn)
        logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
        probs = torch.softmax(logits, dim=-1).nan_to_num(0.0)
        o = torch.einsum("thgk,hkd->thgd", probs, kv[1])
        out[idx] = o.reshape(len(idx), nq, hd).to(q.dtype)
    return out


def ragged_paged_attention(
    q: torch.Tensor,          # [T, nq, hd]
    kv_cache: torch.Tensor,   # [L, P, 2, kvh, page, hd]
    layer: int,
    md: AttentionMetadata,
    scale: float,
    sliding_window: Optional[int] = None,
    logits_soft_cap: Optional[float] = None,
    chunk_attn: Optional[int] = None,
    alibi: Optional[torch.Tensor] = None,
    mm_bidir_spans: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention output [T, nq, hd] in q's dtype. The kernel reads the
    layer through its base pointer in the full cache: nothing is copied."""
    if alibi is not None or mm_bidir_spans is not None:
        raise NotImplementedError(
            "ALiBi and bidirectional spans are not ported to the CUDA "
            "ragged attention kernel yet")
    if kv_cache.dtype != q.dtype:
        raise NotImplementedError(
            f"KV cache dtype {kv_cache.dtype} != query dtype {q.dtype} "
            "(an fp8 cache is not ported yet)")
    cache_layer = kv_cache[layer]
    if q.device.type == "cpu":
        return ref_ragged_paged_attention(
            q, cache_layer, md, scale, sliding_window=sliding_window,
            logits_soft_cap=logits_soft_cap, chunk_attn=chunk_attn)
    if not q.is_cuda or q.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported query tensor: {q.device} {q.dtype}")
    if not (q.is_contiguous() and kv_cache.is_contiguous()):
        raise ValueError("q and the KV cache must be contiguous")
    T, nq, hd = q.shape
    _, _, kvh, page, hd_c = cache_layer.shape
    if hd_c != hd or nq % kvh:
        raise ValueError(f"bad geometry: q {tuple(q.shape)} cache "
                         f"{tuple(cache_layer.shape)}")
    int_args = (md.item_req, md.item_qstart, md.item_qlen, md.item_pos,
                md.seq_lens, md.block_tables)
    for t in int_args:
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError("metadata must be contiguous int32 on q's "
                             "device")
    out = torch.empty_like(q)
    num_items = md.item_req.shape[0]
    if num_items == 0:
        return out
    smem = ragged_smem_bytes(md.block_q, nq // kvh, hd)
    cuda_build.check_smem(
        f"ragged_paged_attention (group {nq // kvh}, head_dim {hd}, "
        f"{md.block_q} tokens a work item)", smem, cuda_build.smem_optin())
    launch = cuda_build.entry("ragged_paged_attention", "rpa_launch",
                              _ARGTYPES)
    err = launch(
        DTYPE_CODES[q.dtype], q.data_ptr(), cache_layer.data_ptr(),
        out.data_ptr(), *(t.data_ptr() for t in int_args), num_items,
        md.block_tables.shape[1], nq, kvh, page, hd, md.block_q, scale,
        sliding_window or 0, chunk_attn or 0, logits_soft_cap or 0.0, smem,
        cuda_build.stream(q.device))
    cuda_build.check(err, "ragged_paged_attention launch")
    ragged_paged_attention.launches += 1
    return out


# Launches of the CUDA kernel (a run sets it to 0 and reads it after).
ragged_paged_attention.launches = 0
