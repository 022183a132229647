"""Suffix match lengths of the token history, for DRY and no-repeat-ngram.

``suffix_match(seq, total_len, break_mask)`` has the contract of the JAX
package's ``_suffix_match_lengths`` (``aphrodite_tpu/sample/sampler.py:
38-67``): for every position j of each row's history ``seq`` [R, L], the
length of the longest u <= MAX_MATCH with seq[j - i] == seq[end - i] for
i = 1..u (end = total_len - 1), as ``m_plain``; ``m_break`` stops, too, at
the first position j - i that ``break_mask`` marks (DRY's sequence
breakers). Both [R, L] int32.

The JAX function is a ``fori_loop`` of MAX_MATCH steps of about ten
[R, L] ops, which XLA fuses; run eagerly that is some 640 launches a call.
On CUDA tensors this launches the hand-written kernel of
``csrc/suffix_match.cu`` (one thread a position, the row's tail in shared
memory). On CPU tensors it runs the plain version ``ref_suffix_match``,
the loop as the JAX function writes it. Integers only: the two are equal
bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from aphrodite_tpu_torch.ops import cuda_build

MAX_MATCH = 64  # static cap on DRY / no-repeat-ngram match lengths

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


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


def suffix_match(seq: torch.Tensor, total_len: torch.Tensor,
                 break_mask: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(m_plain, m_break) [R, L] int32 of the histories ``seq`` [R, L]
    (int32), their lengths ``total_len`` [R] and ``break_mask`` [R, L]
    (bool)."""
    if seq.device.type == "cpu":
        return ref_suffix_match(seq, total_len, break_mask)
    if seq.dim() != 2 or seq.dtype != torch.int32:
        raise ValueError(f"seq must be [R, L] int32, got {seq.dtype} "
                         f"{tuple(seq.shape)}")
    R, L = seq.shape
    if total_len.shape != (R,) or break_mask.shape != (R, L) \
            or break_mask.dtype != torch.bool:
        raise ValueError(f"total_len must be [{R}] and break_mask "
                         f"[{R}, {L}] bool, got {tuple(total_len.shape)} "
                         f"and {break_mask.dtype} "
                         f"{tuple(break_mask.shape)}")
    for t in (total_len, break_mask):
        if t.device != seq.device:
            raise ValueError(f"inputs on {seq.device} and {t.device}")
    seq = seq.contiguous()
    lens = total_len.to(torch.int32).contiguous()
    brk = break_mask.contiguous()
    m_plain = torch.empty((R, L), dtype=torch.int32, device=seq.device)
    m_break = torch.empty_like(m_plain)
    if R * L == 0:
        return m_plain, m_break
    fn = cuda_build.entry("suffix_match", "suffix_match_launch", _ARGTYPES)
    err = fn(seq.data_ptr(), lens.data_ptr(), brk.data_ptr(),
             m_plain.data_ptr(), m_break.data_ptr(), R, L, MAX_MATCH,
             cuda_build.stream(seq.device))
    cuda_build.check(err, "suffix_match")
    suffix_match.launches += 1
    return m_plain, m_break


# Launches of the CUDA kernel (a run sets it to 0 and reads it after).
suffix_match.launches = 0
