"""Paged-attention compute path.

KV cache layout: ``[L, num_pages, 2, num_kv_heads, page_size, head_dim]``
with K at ``[:, :, 0]`` and V at ``[:, :, 1]`` — the JAX package's layout,
so one page of one head is a contiguous ``[page_size, head_dim]`` block.
The head_dim pad to 128 that the TPU kernels needed is not copied.

Semantics: query token ``i`` of request ``r`` at absolute position ``p``
attends to KV slots ``j`` of ``r`` with ``j <= p`` (causal over the paged
context, which already includes this step's freshly written tokens),
further restricted by a sliding window when configured.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.ops.cascade_attention import shared_prefix_attention
from aphrodite_tpu_torch.ops.decode_paged_attention import (
    decode_paged_attention)
from aphrodite_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention, ref_ragged_paged_attention)
from aphrodite_tpu_torch.ops.window_decode_attention import (
    window_decode_attention)
from aphrodite_tpu_torch.utils import to_fp8

__all__ = ["kv_cache_shape", "write_kv", "write_tail", "paged_attention",
           "window_attention", "ref_ragged_paged_attention", "cast_to",
           "as_bytes", "alibi_slopes"]


def kv_cache_shape(num_layers: int, num_pages: int, page_size: int,
                   num_kv_heads: int, head_dim: int
                   ) -> tuple[int, int, int, int, int, int]:
    return (num_layers, num_pages, 2, num_kv_heads, page_size, head_dim)


def cast_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x in a cache's or tail's dtype as the reference's ``astype`` gives it
    (``backend.py:67-74, 105-106, 286``): an fp8 dtype through ``to_fp8``
    (e4m3fn: NaN where |x| rounds past 448, as XLA casts; torch's own cast
    saturates), else torch's cast."""
    if x.dtype == dtype:
        return x
    return to_fp8(x, dtype) if dtype.itemsize == 1 else x.to(dtype)


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor viewed as uint8 (index writes take integer tensors on
    every device), any other as it is."""
    return t.view(torch.uint8) if t.dtype.itemsize == 1 else t


def write_kv(kv_cache: torch.Tensor, layer: int, k: torch.Tensor,
             v: torch.Tensor, slot_mapping: torch.Tensor) -> None:
    """Scatter this step's K/V [T, kvh, hd] into one layer of the cache, in
    place. slot_mapping [T] holds flat slots (page*page_size + offset);
    tokens with slot < 0 land in the null page 0, which the block pool
    never hands out and attention never reads as live."""
    page_size = kv_cache.shape[4]
    slots = slot_mapping.clamp(min=0)
    pages = slots // page_size
    offs = slots % page_size
    cache_l = as_bytes(kv_cache[layer])       # view: written in place
    cache_l[pages, 0, :, offs] = as_bytes(cast_to(k, kv_cache.dtype))
    cache_l[pages, 1, :, offs] = as_bytes(cast_to(v, kv_cache.dtype))


def write_tail(tail: torch.Tensor, rows: torch.Tensor, layer: int,
               step: int) -> None:
    """Write this step's K (or V) rows [R, kvh, hd] into the window tail
    [L, R, kvh, Kw, hd], in place, in the tail's dtype."""
    as_bytes(tail)[layer, :, :, step] = as_bytes(cast_to(rows, tail.dtype))


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """Standard ALiBi head slopes [num_heads] fp32 (Press et al.; HF's
    ``build_alibi_tensor``), computed in float64 and rounded once, as the
    JAX package's ``alibi_slopes`` (``attention/backend.py:123-134``):
    base**(i+1) for the largest power of two n <= num_heads, then the odd
    steps of the next power of two for the heads past n."""
    n = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
    slopes = [base ** (i + 1) for i in range(n)]
    if n < num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * n) - 3)))
        slopes += [extra_base ** (i + 1)
                   for i in range(1, 2 * (num_heads - n), 2)]
    return torch.tensor(slopes, dtype=torch.float64).float()


def paged_attention(q: torch.Tensor, kv_cache: torch.Tensor, layer: int,
                    md: AttentionMetadata, scale: float,
                    sliding_window: Optional[int] = None,
                    logits_soft_cap: Optional[float] = None,
                    chunk_attn: Optional[int] = None,
                    alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over the paged cache: the decode kernel for a pure-decode
    step (``md.decode_mode``, ``backend.py:335-344`` of the JAX package),
    else the ragged kernel (prefill and mixed waves), which alone takes the
    image spans ``md.mm_bidir_spans``: decode queries sit past every span
    (``backend.py:336-337``). ``alibi``: [nq] fp32 slopes or None."""
    if md.decode_mode:
        return decode_paged_attention(
            q, kv_cache, layer, md.block_tables, md.seq_lens, scale,
            sliding_window=sliding_window, chunk_attn=chunk_attn,
            logits_soft_cap=logits_soft_cap, alibi=alibi,
            plan=md.decode_plan)
    return ragged_paged_attention(
        q, kv_cache, layer, md, scale, sliding_window=sliding_window,
        logits_soft_cap=logits_soft_cap, chunk_attn=chunk_attn, alibi=alibi)


def window_attention(q: torch.Tensor, kv_cache: torch.Tensor,
                     tail_k: torch.Tensor, tail_v: torch.Tensor, layer: int,
                     md: AttentionMetadata, scale: float,
                     sliding_window: Optional[int] = None,
                     logits_soft_cap: Optional[float] = None,
                     chunk_attn: Optional[int] = None) -> torch.Tensor:
    """Decode-window attention: frozen paged cache plus the window tail.
    When the batch shares a KV prefix (``md.shared_pages`` / ``shared_len``
    set by the runner) and the layer has no sliding window, chunk or soft
    cap, the shared pages are attended once for the whole batch
    (``shared_prefix_attention``) and the window kernel starts from that
    state: the JAX package's cascade branch (``backend.py:212-273``). On
    CPU tensors both wrappers run their plain versions, which together
    compute ``ref_cascade_window_decode``."""
    init, shared_len = None, 0
    if (md.shared_pages is not None and sliding_window is None
            and chunk_attn is None and logits_soft_cap is None):
        init = shared_prefix_attention(q, kv_cache, layer, md.shared_pages,
                                       md.shared_len, scale, md.shared_plan)
        shared_len = md.shared_len
    return window_decode_attention(
        q, kv_cache, tail_k, tail_v, layer, md.window_step, md.paged_lens,
        md.block_tables, scale, sliding_window=sliding_window,
        chunk_attn=chunk_attn, logits_soft_cap=logits_soft_cap,
        cascade_init=init, shared_len=shared_len, plan=md.window_plan)
