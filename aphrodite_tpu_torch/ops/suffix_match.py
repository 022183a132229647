"""Suffix match lengths of the token history, for DRY and no-repeat-ngram.

``ref_suffix_match(seq, total_len, break_mask)`` has the contract of the
JAX package's ``_suffix_match_lengths`` (``aphrodite_tpu/sample/sampler.py:
38-67``): for every position j of each row's history ``seq`` [R, L], the
length of the longest u <= MAX_MATCH with seq[j - i] == seq[end - i] for
i = 1..u (end = total_len - 1), as ``m_plain``; ``m_break`` stops, too, at
the first position j - i that ``break_mask`` marks (DRY's sequence
breakers). Both [R, L] int32.

Only this plain version is left: it is part of the plain version of the
token-history pass (``ops/history_pass.py``), whose kernel computes the
matches itself, as far as each row needs them.
"""
from __future__ import annotations

import torch

MAX_MATCH = 64  # static cap on DRY / no-repeat-ngram match lengths


def ref_suffix_match(seq: torch.Tensor, total_len: torch.Tensor,
                     break_mask: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: MAX_MATCH steps, each extending every
    position's match by one token while it holds."""
    R, L = seq.shape
    end = total_len.long()[:, None] - 1
    pos = torch.arange(L, device=seq.device)[None, :]
    alive_p = torch.ones((R, L), dtype=torch.bool, device=seq.device)
    alive_b = alive_p.clone()
    m_p = torch.zeros((R, L), dtype=torch.int32, device=seq.device)
    m_b = m_p.clone()
    for u in range(1, MAX_MATCH + 1):
        tail_tok = torch.gather(seq, 1, (end - u).clamp(min=0))
        src_idx = (pos - u).clamp(min=0).expand(R, L)
        src_tok = torch.gather(seq, 1, src_idx)
        src_brk = torch.gather(break_mask, 1, src_idx)
        ok = (src_tok == tail_tok) & (pos - u >= 0) & (end - u >= 0)
        alive_p = alive_p & ok
        alive_b = alive_b & ok & ~src_brk
        m_p += alive_p
        m_b += alive_b
    return m_p, m_b
