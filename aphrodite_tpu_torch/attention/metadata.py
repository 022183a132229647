"""Attention metadata: the per-step tensors describing the ragged batch.

One bundle serves a mixed prefill+decode step. The port's runner lays the
scheduled tokens out back to back (no alignment gaps, no pad tokens), so
every token in ``slot_mapping`` is live; ``-1`` slots are still dropped by
``write_kv``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class AttentionMetadata:
    # [T] int32: request index that each scheduled token belongs to.
    token_req_idx: torch.Tensor
    # [T] int32: absolute context position of each scheduled token.
    token_pos: torch.Tensor
    # [T] int64: flat KV slot (page * page_size + offset); -1 = dropped.
    # None where no KV is written (decode windows, SSM models).
    slot_mapping: Optional[torch.Tensor]
    # [R] int32 total context length (computed + newly scheduled).
    seq_lens: torch.Tensor
    # [R, MAX_PAGES] int32 physical page ids per request; None for SSM
    # models, which read no pages.
    block_tables: Optional[torch.Tensor]
    # ---- ragged-kernel work items (ops/ragged_paged_attention.py). ----
    # [N] int32 each: request, first flat token, token count, first
    # context position of each fixed-size q block.
    item_req: Optional[torch.Tensor] = None
    item_qstart: Optional[torch.Tensor] = None
    item_qlen: Optional[torch.Tensor] = None
    item_pos: Optional[torch.Tensor] = None
    block_q: Optional[int] = None
    # ---- pure-decode step (ops/decode_paged_attention.py). ----
    # True: one query token per request at position seq_lens[r] - 1, its
    # K/V already in the pages; attention runs the decode kernel (the JAX
    # package's ``decode_mode``). Set by the runner's non-window multi-step
    # decode.
    decode_mode: bool = False
    # ---- decode window (ops/window_decode_attention.py). ----
    # Step within the window, and [R] int32 tokens frozen in the pages at
    # window entry. Set only by the runner's window path.
    window_step: Optional[int] = None
    paged_lens: Optional[torch.Tensor] = None
    # ---- SSM (Mamba) state routing (models/mamba.py). ----
    # [R + 1] int32 cumulative count of scheduled tokens per request.
    query_start_loc: Optional[torch.Tensor] = None
    # [R] int32 recurrent-state slot of each request.
    state_slots: Optional[torch.Tensor] = None
    # [R] int32 flat index of each request's first scheduled token. Tokens
    # lie back to back, so this is query_start_loc[:-1]; the field is kept
    # so that the mixer reads like the JAX package's.
    seg_starts: Optional[torch.Tensor] = None
    # [T] bool: live tokens. None = every token is live. The SSM decode
    # window marks the rows past their budget False (the JAX package marks
    # them with slot_mapping -1, which the port's SSM path does not fill).
    token_valid: Optional[torch.Tensor] = None


def build_work_items(seg_starts: np.ndarray, seg_counts: np.ndarray,
                     seq_lens: np.ndarray, num_reqs: int, block_q: int
                     ) -> dict[str, np.ndarray]:
    """Host-side schedule of fixed-size q blocks for the ragged kernel.
    seg_starts[r] / seg_counts[r]: where request r's scheduled tokens live
    in the flat token layout. Returns exactly as many items as needed."""
    item_req, item_qstart, item_qlen, item_pos = [], [], [], []
    for r in range(num_reqs):
        qs = int(seg_starts[r])
        qe = qs + int(seg_counts[r])
        pos0 = int(seq_lens[r]) - (qe - qs)
        off = 0
        while qs + off < qe:
            item_req.append(r)
            item_qstart.append(qs + off)
            item_qlen.append(min(block_q, qe - qs - off))
            item_pos.append(pos0 + off)
            off += block_q
    return {k: np.asarray(v, np.int32) for k, v in (
        ("item_req", item_req), ("item_qstart", item_qstart),
        ("item_qlen", item_qlen), ("item_pos", item_pos))}
