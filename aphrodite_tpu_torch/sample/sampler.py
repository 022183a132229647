"""The Aphrodite sampler pipeline on tensors.

A port of the JAX package's ``sample/sampler.py``: the default order DRY ->
penalties -> no-repeat-ngram -> temperature (+dynatemp) -> top-nsigma ->
top-p/top-k -> top-a -> min-p -> TFS -> eta -> epsilon -> typical ->
quadratic -> XTC (``temperature_last`` moves temperature after XTC), or the
batch's ``sampler_priority``; then log-softmax -> skew -> seeded Gumbel-max
sampling. Every stage is self-masking on per-row parameters and
``SamplerFlags`` gates whole groups, so an all-greedy batch runs
``greedy_sample`` alone.

Two parts run as hand-written kernels on the card, where eager PyTorch
would launch tens to hundreds of small ops a call: the token-history pass
(``ops/history_pass.py``: DRY, the penalties and no-repeat-ngram in one
launch a draw, at the tokens of each row's history alone) and the
Gumbel-max draw (``ops/gumbel_sample.py``, threefry2x32 in registers: no
[R, V] noise tensor). On CPU tensors both run their plain versions.

``sample_tokens`` leaves its ``logits`` as they were unless the caller
hands them over (``donate_logits``: the decode window's sampler, which
reads them no more); the pass then writes into them, else into a copy.

Deviations from the JAX package, each with the same results:
- sorts are ``torch.sort(stable=True)``, as ``jnp.sort``/``argsort`` are
  stable, and the top-k logprobs a stable sort's head, as
  ``jax.lax.top_k`` (equal values in index order);
- scatters with a drop column write into a [R, V + 1] buffer and slice it
  (the history pass's plain version, and min_tokens);
- XTC's per-row uniform comes packed in the metadata for a window's
  steps (``metadata.build_sampling_arrays``), from the same keys;
- an all-greedy batch runs the argmax alone (``SamplerFlags.all_greedy``
  is set only where that is the sampled branch's result).
"""
from __future__ import annotations

from typing import Optional

import torch

from aphrodite_tpu_torch.ops.gumbel_sample import gumbel_sample
from aphrodite_tpu_torch.ops.history_pass import history_pass, scatter_drop
from aphrodite_tpu_torch.sample.metadata import SamplerFlags, SamplingMetadata
from aphrodite_tpu_torch.sampling_params import SamplerID, SamplingParams

_TEMPERATURE_MIN = 2e-2
NEG_INF = float("-inf")


def check_supported(params: SamplingParams) -> None:
    """Raise on the fields whose modules are not ported yet."""
    unported = (
        ("guided_decoding", params.guided_decoding is not None,
         "structured output (guided decoding) is not ported"),
        ("stop", bool(params.stop),
         "stop strings need a tokenizer, which is not ported"),
        ("bad_words", bool(params.bad_words),
         "bad_words need a tokenizer, which is not ported"),
        ("logits_processors", bool(params.logits_processors),
         "logits_processors are not ported"),
        ("best_of", params.best_of is not None and params.best_of != params.n,
         "best_of beyond n is not ported"))
    for name, bad, why in unported:
        if bad:
            raise NotImplementedError(
                f"SamplingParams.{name}={getattr(params, name)!r}: {why}")


def greedy_sample(logits: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """logits [R, V] -> (argmax tokens [R] int64, first index on ties as
    ``jnp.argmax``; their fp32 log-softmax logprobs [R])."""
    tokens = torch.argmax(logits, dim=-1)
    logprob = torch.log_softmax(logits.float(), dim=-1).gather(
        1, tokens[:, None])[:, 0]
    return tokens, logprob


def _col(x: torch.Tensor) -> torch.Tensor:
    return x[:, None]


# --------------------------------------------------------------------------
# temperature and truncation
# --------------------------------------------------------------------------
def _entropy(logits: torch.Tensor) -> torch.Tensor:
    lsm = torch.log_softmax(logits, dim=-1)
    p = torch.exp(lsm)
    plogp = torch.where(torch.isfinite(lsm), p * lsm, 0.0)
    return -plogp.sum(dim=-1)


def _apply_temperature(logits: torch.Tensor, md: SamplingMetadata,
                       dynatemp: bool) -> torch.Tensor:
    temps = md.temperature
    if dynatemp:
        ent = _entropy(logits)
        max_ent = torch.log(torch.isfinite(logits).sum(dim=-1).float())
        norm_ent = torch.where(max_ent > 0, ent / max_ent, 0.0)
        dyn = md.dynatemp_min + (md.dynatemp_max - md.dynatemp_min) * \
            torch.pow(norm_ent, md.dynatemp_exp)
        dyn_on = (md.dynatemp_min != 0) | (md.dynatemp_max != 0)
        temps = torch.where(dyn_on, dyn, temps)
    temps = torch.where(torch.isnan(temps) | (temps <= _TEMPERATURE_MIN),
                        _TEMPERATURE_MIN, temps)
    # Low temperatures shift the range to [-inf, 1] against saturation.
    mx = logits.max(dim=-1, keepdim=True).values
    logits = torch.where(_col(temps < 0.1), logits - (mx - 1), logits)
    return logits / _col(temps)


def _sort(x: torch.Tensor, descending: bool = False):
    """(values, indices) of a stable sort along the last axis, as
    ``jnp.sort`` / ``jnp.argsort`` (of -x for descending)."""
    if descending:
        vals, idx = torch.sort(-x, dim=-1, stable=True)
        return -vals, idx
    return torch.sort(x, dim=-1, stable=True)


def topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, as ``jax.lax.top_k``: equal values in
    index order (``torch.topk`` leaves their order open)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _unsort(sorted_vals: torch.Tensor, sort_idx: torch.Tensor
            ) -> torch.Tensor:
    return torch.empty_like(sorted_vals).scatter_(1, sort_idx, sorted_vals)


def _apply_top_k_top_p(logits: torch.Tensor,
                       md: SamplingMetadata) -> torch.Tensor:
    R, V = logits.shape
    ls, idx = _sort(logits)  # ascending
    k = torch.where(md.top_k > 0, md.top_k, V).long()
    kth = torch.gather(ls, 1, _col(V - k))
    ls = torch.where(ls < kth, NEG_INF, ls)
    probs = torch.softmax(ls, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    mask = csum <= _col(1.0 - md.top_p)
    mask[:, -1] = False  # keep at least one
    ls = torch.where(mask, NEG_INF, ls)
    return _unsort(ls, idx)


def _apply_min_p(logits, md):
    probs = torch.softmax(logits, dim=-1)
    top = probs.max(dim=-1, keepdim=True).values
    remove = probs < _col(md.min_p) * top
    return torch.where(remove & _col(md.min_p > 0), NEG_INF, logits)


def _apply_top_a(logits, md):
    probs = torch.softmax(logits, dim=-1)
    top = probs.max(dim=-1, keepdim=True).values
    remove = probs < (top * top * _col(md.top_a))
    return torch.where(remove & _col(md.top_a > 0), NEG_INF, logits)


def _apply_tfs(logits, md):
    R, V = logits.shape
    ls, idx = _sort(logits, descending=True)
    probs = torch.softmax(ls, dim=-1)
    d2 = torch.abs(torch.diff(torch.diff(probs, dim=-1), dim=-1))
    d2n = d2 / torch.clamp(d2.sum(dim=-1, keepdim=True), min=1e-20)
    cdf = torch.cumsum(d2n, dim=-1)
    inner = cdf > _col(md.tfs)
    mask = torch.cat([torch.zeros((R, 1), dtype=torch.bool,
                                  device=logits.device), inner,
                      torch.ones((R, 1), dtype=torch.bool,
                                 device=logits.device)], dim=-1)
    ls = torch.where(mask & _col(md.tfs < 1.0), NEG_INF, ls)
    return _unsort(ls, idx)


def _keep_argmax(mask: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    top = torch.argmax(probs, dim=-1, keepdim=True)
    return mask.scatter(1, top, False)


def _apply_eta(logits, md):
    probs = torch.exp(torch.log_softmax(logits, dim=-1))
    neg_ent = -_entropy(logits)
    eps = _col(torch.minimum(md.eta_cutoff,
                             torch.sqrt(md.eta_cutoff) * torch.exp(neg_ent)))
    mask = _keep_argmax(probs < eps, probs)
    return torch.where(mask & _col(md.eta_cutoff > 0), NEG_INF, logits)


def _apply_epsilon(logits, md):
    probs = torch.softmax(logits, dim=-1)
    mask = _keep_argmax(probs < _col(md.epsilon_cutoff), probs)
    return torch.where(mask & _col(md.epsilon_cutoff > 0), NEG_INF, logits)


def _apply_typical(logits, md):
    lsm = torch.log_softmax(logits, dim=-1)
    probs = torch.exp(lsm)
    neg_ent = _col(-_entropy(logits))
    dev = torch.abs(neg_ent - torch.where(torch.isfinite(lsm), lsm, -1e30))
    _, idx = _sort(dev)  # ascending deviation
    reordered = torch.gather(probs, 1, idx)
    mask_sorted = torch.cumsum(reordered, dim=-1) >= _col(md.typical_p)
    mask_sorted[:, 0] = False
    mask = _unsort(mask_sorted, idx)
    return torch.where(mask & _col(md.typical_p < 1.0), NEG_INF, logits)


def _apply_quadratic(logits, md):
    sf = _col(md.smoothing_factor)
    sc = _col(md.smoothing_curve)
    k = sf * (3 - sc) / 2
    s = sf * (sc - 1) / 2
    mx = logits.max(dim=-1, keepdim=True).values
    diff = logits - mx
    corr = diff - diff * diff * (s * diff - k)
    corr = torch.where(torch.isnan(corr), 0.0, corr)
    return torch.where(sf != 0, logits - corr, logits)


def _apply_xtc(logits, md, u):
    R, V = logits.shape
    apply_row = (u < md.xtc_probability) & (md.xtc_probability > 0)
    probs = torch.softmax(logits, dim=-1)
    sp, sidx = _sort(probs, descending=True)
    above = sp[:, 1:] >= _col(md.xtc_threshold)
    count = above.sum(dim=-1)  # tokens to remove from the top
    mask_sorted = torch.arange(V, device=logits.device)[None, :] < \
        _col(count)
    mask = _unsort(mask_sorted, sidx)
    return torch.where(mask & _col(apply_row), NEG_INF, logits)


def _apply_nsigma(logits, md):
    # torch.std's default: unbiased (ddof = 1), as the JAX stage asks.
    std = torch.std(logits, dim=-1, keepdim=True)
    thr = logits.max(dim=-1, keepdim=True).values - _col(md.nsigma) * std
    return torch.where((logits < thr) & _col(md.nsigma > 0), NEG_INF,
                       logits)


def _apply_min_tokens(logits, md, step_offset):
    R, V = logits.shape
    active = (md.out_len + step_offset) < md.min_tokens
    tgt = torch.where(_col(active), md.stop_tokens, -1)
    tgt = torch.where(tgt < 0, V, tgt)
    mask = scatter_drop(R, V, tgt, 1, "amax", torch.int32) > 0
    return torch.where(mask, NEG_INF, logits)


def _apply_allowed_tokens(logits, md):
    """Rows with allowed_token_ids keep only those logits (the rest -inf);
    unrestricted rows pass through."""
    R, V = logits.shape
    allowed = md.allowed_tokens
    has = (allowed >= 0).any(dim=1)
    vals = torch.gather(logits, 1, allowed.clamp(min=0).long())
    tgt = torch.where(allowed < 0, V, allowed).long()
    masked = torch.full((R, V + 1), NEG_INF, dtype=logits.dtype,
                        device=logits.device).scatter_(1, tgt, vals)[:, :V]
    return torch.where(_col(has), masked, logits)


def _apply_logit_bias(logits, md):
    R, V = logits.shape
    tgt = torch.where(md.bias_tokens < 0, V, md.bias_tokens).long()
    buf = torch.nn.functional.pad(logits, (0, 1))
    return buf.scatter_add_(1, tgt, md.bias_values)[:, :V]


# --------------------------------------------------------------------------
# the pipeline
# --------------------------------------------------------------------------
def sample_tokens(logits: torch.Tensor, md: Optional[SamplingMetadata],
                  flags: SamplerFlags, max_logprobs: int = 0,
                  step_offset: int = 0, donate_logits: bool = False) -> dict:
    """Run the pipeline; returns a dict with ``tokens`` [R] int64,
    ``logprob`` [R] fp32 (of the chosen token) and, when max_logprobs > 0,
    ``topk_values`` / ``topk_indices`` [R, max_logprobs].

    ``step_offset`` advances each row's counter (out_len + step_offset):
    sub-step i of a decode window passes i, with metadata built once for
    the window (``num_steps`` > i: XTC reads its draw from
    ``md.xtc_uniform[i]``). An all-greedy batch (no stage on) runs
    ``greedy_sample`` alone; its ``md`` may be None. ``donate_logits``:
    the caller reads ``logits`` no more, and the token-history pass may
    write into them (else they are left unchanged)."""
    if flags.all_greedy:
        tokens, lp = greedy_sample(logits)
        out = {"tokens": tokens, "logprob": lp}
        if max_logprobs > 0:
            out["topk_values"], out["topk_indices"] = topk(
                torch.log_softmax(logits.float(), dim=-1), max_logprobs)
        return out
    caller, logits = logits, logits.float()

    if flags.do_allowed:
        logits = _apply_allowed_tokens(logits, md)
    if flags.do_logit_bias:
        logits = _apply_logit_bias(logits, md)
    if flags.do_min_tokens:
        logits = _apply_min_tokens(logits, md, step_offset)
    if flags.track_tokens:
        # DRY -> penalties -> no-repeat-ngram, one launch; in place where
        # the logits are the caller's to give or this function's own (and
        # contiguous: logit_bias leaves a view).
        own = donate_logits or logits is not caller
        logits = history_pass(logits, md, flags,
                              inplace=own and logits.is_contiguous())

    def xtc_stage(lg):
        if not flags.do_xtc:
            return lg
        return _apply_xtc(lg, md, md.xtc_uniform[step_offset])

    adv = flags.do_advanced
    stages = {
        SamplerID.TEMPERATURE: lambda lg: _apply_temperature(lg, md, adv),
        SamplerID.TOP_NSIGMA: lambda lg: _apply_nsigma(lg, md) if adv else lg,
        SamplerID.TOP_K: lambda lg: (_apply_top_k_top_p(lg, md)
                                     if flags.do_top_k_p else lg),
        SamplerID.TOP_P: lambda lg: lg,  # fused with TOP_K above
        SamplerID.TOP_A: lambda lg: _apply_top_a(lg, md) if adv else lg,
        SamplerID.MIN_P: lambda lg: (_apply_min_p(lg, md)
                                     if flags.do_min_p else lg),
        SamplerID.TFS: lambda lg: _apply_tfs(lg, md) if adv else lg,
        SamplerID.ETA: lambda lg: _apply_eta(lg, md) if adv else lg,
        SamplerID.EPSILON: lambda lg: _apply_epsilon(lg, md) if adv else lg,
        SamplerID.TYPICAL: lambda lg: _apply_typical(lg, md) if adv else lg,
        SamplerID.QUADRATIC: lambda lg: (_apply_quadratic(lg, md)
                                         if adv else lg),
        SamplerID.XTC: xtc_stage,
        # The token-history stages and min_tokens ran above.
        SamplerID.DRY: lambda lg: lg,
        SamplerID.PENALTIES: lambda lg: lg,
        SamplerID.NO_REPEAT_NGRAM: lambda lg: lg,
        SamplerID.MIN_TOKENS: lambda lg: lg,
    }
    if flags.order:
        for sid in flags.order:
            logits = stages[SamplerID(sid)](logits)
    else:
        if not flags.do_temp_last:
            logits = _apply_temperature(logits, md, adv)
        if adv:
            logits = _apply_nsigma(logits, md)
        if flags.do_top_k_p:
            logits = _apply_top_k_top_p(logits, md)
        if adv:
            logits = _apply_top_a(logits, md)
        if flags.do_min_p:
            logits = _apply_min_p(logits, md)
        if adv:
            logits = _apply_tfs(logits, md)
            logits = _apply_eta(logits, md)
            logits = _apply_epsilon(logits, md)
            logits = _apply_typical(logits, md)
            logits = _apply_quadratic(logits, md)
        logits = xtc_stage(logits)
        if flags.do_temp_last:
            logits = _apply_temperature(logits, md, adv)

    logprobs_final = torch.log_softmax(logits, dim=-1)
    if flags.do_skew:
        probs = torch.exp(logprobs_final)
        cum = torch.cumsum(probs, dim=-1)
        cum = torch.pow(cum, _col(torch.exp(md.skew)))
        probs = torch.diff(cum, dim=-1, prepend=torch.zeros_like(cum[:, :1]))
        logprobs_final = torch.log(torch.clamp(probs, min=1e-30))
    # Gumbel-max on the final distribution; greedy rows take the argmax of
    # the processed logits, before the noise.
    sampled = gumbel_sample(logprobs_final, md.seeds, md.out_len, step_offset)
    tokens = torch.where(md.is_greedy, torch.argmax(logits, dim=-1), sampled)

    chosen_lp = torch.gather(logprobs_final, 1, tokens[:, None])[:, 0]
    out = {"tokens": tokens, "logprob": chosen_lp}
    if max_logprobs > 0:
        vals, idxs = topk(logprobs_final, max_logprobs)
        out["topk_values"] = vals
        out["topk_indices"] = idxs
    return out
