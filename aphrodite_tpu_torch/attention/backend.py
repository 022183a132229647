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

from typing import Optional

import torch

from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.ops.decode_paged_attention import (
    decode_paged_attention)
from aphrodite_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention, ref_ragged_paged_attention)
from aphrodite_tpu_torch.ops.window_decode_attention import (
    window_decode_attention)

__all__ = ["kv_cache_shape", "write_kv", "write_tail", "paged_attention",
           "window_attention", "ref_ragged_paged_attention"]


def kv_cache_shape(num_layers: int, num_pages: int, page_size: int,
                   num_kv_heads: int, head_dim: int
                   ) -> tuple[int, int, int, int, int, int]:
    return (num_layers, num_pages, 2, num_kv_heads, page_size, head_dim)


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
    cache_l = kv_cache[layer]                 # view: written in place
    cache_l[pages, 0, :, offs] = k.to(kv_cache.dtype)
    cache_l[pages, 1, :, offs] = v.to(kv_cache.dtype)


def write_tail(tail: torch.Tensor, rows: torch.Tensor, layer: int,
               step: int) -> None:
    """Write this step's K (or V) rows [R, kvh, hd] into the window tail
    [L, R, kvh, Kw, hd], in place."""
    tail[layer, :, :, step] = rows.to(tail.dtype)


def paged_attention(q: torch.Tensor, kv_cache: torch.Tensor, layer: int,
                    md: AttentionMetadata, scale: float,
                    sliding_window: Optional[int] = None,
                    logits_soft_cap: Optional[float] = None,
                    chunk_attn: Optional[int] = None,
                    alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over the paged cache: the decode kernel for a pure-decode
    step (``md.decode_mode``, ``backend.py:335-344`` of the JAX package),
    else the ragged kernel (prefill and mixed waves). ``alibi``: [nq] fp32
    slopes or None."""
    if md.decode_mode:
        return decode_paged_attention(
            q, kv_cache, layer, md.block_tables, md.seq_lens, scale,
            sliding_window=sliding_window, chunk_attn=chunk_attn,
            logits_soft_cap=logits_soft_cap, alibi=alibi)
    return ragged_paged_attention(
        q, kv_cache, layer, md, scale, sliding_window=sliding_window,
        logits_soft_cap=logits_soft_cap, chunk_attn=chunk_attn, alibi=alibi)


def window_attention(q: torch.Tensor, kv_cache: torch.Tensor,
                     tail_k: torch.Tensor, tail_v: torch.Tensor, layer: int,
                     md: AttentionMetadata, scale: float,
                     sliding_window: Optional[int] = None,
                     logits_soft_cap: Optional[float] = None,
                     chunk_attn: Optional[int] = None) -> torch.Tensor:
    """Decode-window attention: frozen paged cache plus the window tail."""
    return window_decode_attention(
        q, kv_cache, tail_k, tail_v, layer, md.window_step, md.paged_lens,
        md.block_tables, scale, sliding_window=sliding_window,
        chunk_attn=chunk_attn, logits_soft_cap=logits_soft_cap)
