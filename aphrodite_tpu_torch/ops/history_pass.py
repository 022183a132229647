"""The token-history pass: DRY, the penalties and no-repeat-ngram at once.

``history_pass(logits, md, flags)`` computes what the JAX package's
``_apply_dry``, ``_apply_penalties`` and ``_apply_no_repeat_ngram``
(``aphrodite_tpu/sample/sampler.py:70-167``, with ``_suffix_match_lengths``
at ``:38-67``) compute in that order, each where ``flags`` turns it on
(``do_dry``, ``do_penalties``, ``do_ngram``) and each row self-masking on
its own parameters.

On CUDA tensors it launches the hand-written kernel of
``csrc/history_pass.cu``: one launch a draw, one block a row, the row's
history read once and the three stages applied only at the tokens that
occur in it (a per-row table of the distinct tokens, no [R, V] scratch).
On CPU tensors it runs the plain version ``ref_history_pass``, the three
stages as eager [R, V] PyTorch over the suffix match lengths of
``ops/suffix_match.py``. ``touched_model`` is the kernel's algorithm in
plain Python, for the CPU tests. The kernel and the plain version agree
bit for bit: the same fp32 operations in the same order, rounded one by
one, and ``powf`` where torch calls it (``chip_smoke.py`` phase 2).

With ``inplace`` the result is written into ``logits`` (which must then
be contiguous); without it ``logits`` is left as it was and a copy is
returned.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops.suffix_match import MAX_MATCH, ref_suffix_match
from aphrodite_tpu_torch.sample.metadata import (MAX_BREAKERS, SamplerFlags,
                                                 SamplingMetadata)

NEG_INF = float("-inf")
# The launch's stage bits (kDry, kPenalties, kNgram of the kernel).
DRY, PENALTIES, NGRAM = 1, 2, 4
# Blocks of a launch whose tables live in device memory (histories too
# long for shared memory): each block's slice is 16 * cap bytes.
TABLE_BLOCKS = 32

_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_INT = ("token_seq", "prompt_len", "total_len", "dry_breakers",
        "dry_allowed", "dry_range", "no_repeat_ngram")
_FLOAT = ("dry_multiplier", "dry_base", "presence_penalty",
          "frequency_penalty", "repetition_penalty")
_TABLES: dict[int, torch.Tensor] = {}


# --------------------------------------------------------------------------
# the plain version: the sampler's eager stages over [R, V]
# --------------------------------------------------------------------------
def _col(x: torch.Tensor) -> torch.Tensor:
    return x[:, None]


def scatter_drop(R: int, V: int, targets: torch.Tensor, values,
                 reduce: str, dtype) -> torch.Tensor:
    """[R, V] result of scattering ``values`` at ``targets`` (V = drop)
    into zeros, through a [R, V + 1] buffer."""
    buf = torch.zeros((R, V + 1), dtype=dtype, device=targets.device)
    # A fill for a constant, not a copy from the host (which would wait
    # for the device's queue).
    src = (values.to(dtype) if isinstance(values, torch.Tensor)
           else torch.full(targets.shape, values, dtype=dtype,
                           device=targets.device))
    if reduce == "sum":
        buf.scatter_add_(1, targets.long(), src)
    else:
        buf.scatter_reduce_(1, targets.long(), src, "amax")
    return buf[:, :V]


def _match_lengths(md: SamplingMetadata, dry: bool
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(break_mask, m_plain, m_break) [R, L] of the token history: one
    suffix match serves DRY (``m_break``, stopping at the rows' breakers;
    the mask is all False unless ``dry``) and no-repeat-ngram
    (``m_plain``, which does not read the mask)."""
    seq = md.token_seq
    if dry:
        break_mask = (seq[:, :, None] == md.dry_breakers[:, None, :]).any(-1)
    else:
        break_mask = torch.zeros_like(seq, dtype=torch.bool)
    return (break_mask, *ref_suffix_match(seq, md.total_len, break_mask))


def _apply_dry(logits: torch.Tensor, md: SamplingMetadata,
               break_mask: torch.Tensor, m_break: torch.Tensor
               ) -> torch.Tensor:
    """DRY: penalise tokens that would extend a sequence already seen.
    ``break_mask`` and ``m_break`` come from ``_match_lengths``."""
    R, V = logits.shape
    seq, L = md.token_seq, md.token_seq.shape[1]
    end = md.total_len.long() - 1
    pos = torch.arange(L, device=seq.device)[None, :]

    # How far back from the tail matching may reach before a breaker: the
    # first i in [0, MAX_MATCH] with a break at end - i (i = 0: the last
    # token is a breaker and DRY is off for the row).
    i_range = torch.arange(MAX_MATCH + 1, device=seq.device)[None, :]
    tail_idx = (_col(end) - i_range).clamp(min=0)
    tail_brk = (torch.gather(break_mask, 1, tail_idx)
                | (_col(end) - i_range < 0))
    any_brk = tail_brk.any(dim=1)
    window = (torch.argmax(tail_brk.to(torch.uint8), dim=1)
              + torch.where(any_brk, 0, MAX_MATCH + 1))

    last_tok = torch.gather(seq, 1, _col(end.clamp(min=0)))
    range_start = _col(torch.where(md.dry_range > 0,
                                   md.total_len - md.dry_range, 0))

    m = torch.minimum(m_break, _col(window - 1).clamp(min=0))
    is_endpoint = ((seq == last_tok) & (pos < _col(end))
                   & (pos >= range_start) & (m > 0))
    new_len = torch.where(is_endpoint, m + 1, 0)
    nxt = torch.gather(seq, 1, (pos + 1).clamp(max=L - 1).expand(R, L))
    targets = torch.where(is_endpoint, nxt, V)
    ngram_lens = scatter_drop(R, V, targets, new_len, "amax", torch.int32)

    row_on = _col((md.dry_multiplier > 0) & (window > md.dry_allowed)
                  & (md.total_len >= 2))
    pen = _col(md.dry_multiplier) * torch.pow(
        _col(md.dry_base), (ngram_lens - _col(md.dry_allowed)).float())
    return torch.where(row_on & (ngram_lens > 0), logits - pen, logits)


def _apply_no_repeat_ngram(logits: torch.Tensor, md: SamplingMetadata,
                           m_plain: torch.Tensor) -> torch.Tensor:
    """Ban tokens completing an n-gram already present in context.
    ``m_plain`` comes from ``_match_lengths``."""
    R, V = logits.shape
    seq, L = md.token_seq, md.token_seq.shape[1]
    end = md.total_len.long() - 1
    pos = torch.arange(L, device=seq.device)[None, :]

    n = _col(md.no_repeat_ngram)
    last_tok = torch.gather(seq, 1, _col(end.clamp(min=0)))
    hit = ((seq == last_tok) & (m_plain >= n - 2) & (pos < _col(end))
           & (pos >= n - 2))
    nxt = torch.gather(seq, 1, (pos + 1).clamp(max=L - 1).expand(R, L))
    targets = torch.where(hit, nxt, V)
    banned = scatter_drop(R, V, targets, 1, "amax", torch.int32) > 0
    row_on = _col((md.no_repeat_ngram > 0)
                  & (md.total_len >= md.no_repeat_ngram))
    return torch.where(row_on & banned, NEG_INF, logits)


def _apply_penalties(logits: torch.Tensor,
                     md: SamplingMetadata) -> torch.Tensor:
    """Presence, frequency and repetition penalties."""
    R, V = logits.shape
    seq, L = md.token_seq, md.token_seq.shape[1]
    pos = torch.arange(L, device=seq.device)[None, :]
    in_prompt = pos < _col(md.prompt_len)
    in_output = (pos >= _col(md.prompt_len)) & (pos < _col(md.total_len))
    prompt_counts = scatter_drop(R, V, torch.where(in_prompt, seq, V), 1,
                                 "sum", torch.int32)
    output_counts = scatter_drop(R, V, torch.where(in_output, seq, V), 1,
                                 "sum", torch.int32)
    prompt_mask = prompt_counts > 0
    output_mask = output_counts > 0
    rep = torch.where(prompt_mask | output_mask,
                      _col(md.repetition_penalty), 1.0)
    logits = torch.where(logits > 0, logits / rep, logits * rep)
    logits = logits - _col(md.frequency_penalty) * output_counts
    logits = logits - _col(md.presence_penalty) * output_mask
    return logits


def ref_history_pass(logits: torch.Tensor, md: SamplingMetadata,
                     flags: SamplerFlags) -> torch.Tensor:
    """Plain PyTorch version: the three eager stages in the pipeline's
    order, over one suffix match of the history. Returns a new tensor."""
    if flags.do_dry or flags.do_ngram:
        break_mask, m_plain, m_break = _match_lengths(md, flags.do_dry)
    if flags.do_dry:
        logits = _apply_dry(logits, md, break_mask, m_break)
    if flags.do_penalties:
        logits = _apply_penalties(logits, md)
    if flags.do_ngram:
        logits = _apply_no_repeat_ngram(logits, md, m_plain)
    return logits


# --------------------------------------------------------------------------
# the kernel's algorithm, for the CPU tests
# --------------------------------------------------------------------------
def touched_model(logits: torch.Tensor, md: SamplingMetadata,
                  flags: SamplerFlags) -> torch.Tensor:
    """``csrc/history_pass.cu`` step by step in plain Python: per row the
    tail and DRY's window, the positions' counts and the matches as far as
    the row needs them, a table of the touched tokens, then DRY ->
    penalties -> ban at those tokens alone, in fp32 tensor operations.
    Returns a new tensor."""
    out = logits.clone()
    R, V = logits.shape
    L = md.token_seq.shape[1]
    col = {f: getattr(md, f).tolist() for f in _INT + _FLOAT}
    for r in range(R):
        h = col["token_seq"][r]
        T = min(col["total_len"][r], L)
        P = min(col["prompt_len"][r], L)
        end = T - 1
        brk = set(col["dry_breakers"][r])
        n = max(max(T, P) if flags.do_penalties else T, 0)
        window = next((i for i in range(MAX_MATCH + 1)
                       if end - i < 0 or (flags.do_dry and h[end - i] in brk)),
                      MAX_MATCH + 1)
        allowed, ngram = col["dry_allowed"][r], col["no_repeat_ngram"][r]
        dry_on = (flags.do_dry and col["dry_multiplier"][r] > 0
                  and window > allowed and T >= 2)
        ng_on = flags.do_ngram and ngram > 0 and T >= ngram
        dry_cap = max(window - 1, 0) if dry_on else 0
        need = min(MAX_MATCH, max(dry_cap, ngram - 2 if ng_on else 0))
        rng = col["dry_range"][r]
        range_start = T - rng if rng > 0 else 0
        last = h[end] if end >= 0 else -1
        table: dict[int, list] = {}  # token -> [dry, prompt, output, ban]

        def slot(tok):
            return table.setdefault(tok, [0, 0, 0, False])
        for j in range(n if flags.do_penalties else max(end, 0)):
            tok = h[j]
            if flags.do_penalties and 0 <= tok < V:
                slot(tok)[1 if j < P else 2] += 1  # j < max(T, P)
            if not (dry_on or ng_on) or j >= end or tok != last:
                continue
            mp = mb = 0
            alive_b = True
            for u in range(1, need + 1):
                if j - u < 0 or h[j - u] != h[end - u]:
                    break
                mp += 1
                if alive_b:
                    if dry_on and h[j - u] in brk:
                        alive_b = False
                    else:
                        mb += 1
            nxt = h[j + 1]
            if not 0 <= nxt < V:
                continue
            m = min(mb, dry_cap)
            if dry_on and j >= range_start and m > 0:
                slot(nxt)[0] = max(slot(nxt)[0], m + 1)
            if ng_on and mp >= ngram - 2 and j >= ngram - 2:
                slot(nxt)[3] = True
        if not table:
            continue
        toks = torch.tensor(sorted(table))
        d, pc, oc, ban = (torch.tensor([table[t][k] for t in sorted(table)])
                          for k in range(4))
        f32 = {f: torch.tensor(col[f][r], dtype=torch.float32)
               for f in _FLOAT}
        x = out[r, toks]
        x = torch.where(d > 0, x - f32["dry_multiplier"] * torch.pow(
            f32["dry_base"], (d - allowed).float()), x)
        if flags.do_penalties:
            rep = torch.where((pc > 0) | (oc > 0),
                              f32["repetition_penalty"], 1.0)
            x = torch.where(x > 0, x / rep, x * rep)
            x = x - f32["frequency_penalty"] * oc
            x = x - f32["presence_penalty"] * (oc > 0)
        out[r, toks] = torch.where(ban, NEG_INF, x)
    return out


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------
class HistoryPlan(NamedTuple):
    """A launch's sizes: the table's slots a block (a power of two, at
    least twice the distinct tokens a row can hold), its dynamic shared
    memory (0: the tables in device memory), its blocks and the zeroed
    int32 table ints it needs in device memory."""
    cap: int
    shared_bytes: int
    blocks: int
    table_ints: int


def history_plan(R: int, L: int, V: int,
                 smem_optin: int = cuda_build.H100_SMEM_OPTIN
                 ) -> HistoryPlan:
    """The launch of ``csrc/history_pass.cu`` for R rows of L history
    slots over a vocabulary of V: in shared memory, one block a row, where
    the table (16 bytes a slot) and the history (4 a slot) fit beside the
    kernel's 328 static bytes; else ``TABLE_BLOCKS`` blocks over tables in
    device memory."""
    cap = max(64, 1 << (2 * min(L, V) - 1).bit_length())
    shared = 4 * (4 * cap + L)
    if shared + 328 <= smem_optin:
        return HistoryPlan(cap, shared, max(R, 1), 0)
    blocks = max(min(R, TABLE_BLOCKS), 1)
    return HistoryPlan(cap, 0, blocks, blocks * 4 * cap)


def _table(device, ints: int) -> int:
    """A pointer to ``ints`` zeroed int32 of ``device``, grown as needed;
    every launch leaves it zero."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    buf = _TABLES.get(idx)
    if buf is None or buf.numel() < ints:
        buf = torch.zeros(ints, dtype=torch.int32, device=device)
        _TABLES[idx] = buf
    return buf.data_ptr()


def _inputs(logits: torch.Tensor, md: SamplingMetadata) -> list:
    """The metadata's tensors the kernel reads, checked and contiguous."""
    R = logits.shape[0]
    seq = md.token_seq
    if seq.dim() != 2 or seq.shape[0] != R:
        raise ValueError(f"token_seq must be [{R}, L], got "
                         f"{tuple(seq.shape)}")
    out = []
    for name in _INT[:4] + _FLOAT[:2] + _INT[4:] + _FLOAT[2:]:
        t = getattr(md, name)
        want = (torch.int32 if name in _INT else torch.float32)
        shape = ((R, seq.shape[1]) if name == "token_seq" else
                 (R, MAX_BREAKERS) if name == "dry_breakers" else (R,))
        if t.dtype != want or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {want} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != logits.device:
            raise ValueError(f"{name} on {t.device}, logits on "
                             f"{logits.device}")
        out.append(t.contiguous())
    return out


def history_pass(logits: torch.Tensor, md: SamplingMetadata,
                 flags: SamplerFlags, inplace: bool = False
                 ) -> torch.Tensor:
    """fp32 ``logits`` [R, V] after DRY, the penalties and no-repeat-ngram
    (those ``flags`` turns on) over ``md``'s token history; one kernel
    launch on CUDA tensors."""
    stages = (DRY * flags.do_dry + PENALTIES * flags.do_penalties
              + NGRAM * flags.do_ngram)
    if logits.device.type == "cpu":
        out = (ref_history_pass(logits, md, flags) if stages
               else logits.clone())
        return logits.copy_(out) if inplace else out
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError(f"logits must be [R, V] float32, got "
                         f"{logits.dtype} {tuple(logits.shape)}")
    if inplace and not logits.is_contiguous():
        raise ValueError("history_pass(inplace=True) needs contiguous logits")
    args = _inputs(logits, md)
    out = logits if inplace else logits.clone(
        memory_format=torch.contiguous_format)
    R, V = out.shape
    if R == 0 or V == 0 or not stages:
        return out
    L = args[0].shape[1]
    plan = history_plan(R, L, V)
    table = _table(out.device, plan.table_ints) if plan.table_ints else None
    fn = cuda_build.entry("history_pass", "history_pass_launch", _ARGTYPES)
    err = fn(out.data_ptr(), *(t.data_ptr() for t in args), table, R, V, L,
             plan.cap, stages, plan.blocks, cuda_build.stream(out.device))
    cuda_build.check(err, "history_pass")
    history_pass.launches += 1
    return out


# Launches of the CUDA kernel (a run sets it to 0 and reads it after).
history_pass.launches = 0
