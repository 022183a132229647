"""Batched sampling metadata: per-request parameters packed into tensors.

A copy of the JAX package's ``sample/metadata.py`` for the port. Every
sampler stage reads a per-row parameter vector and is self-masking
(disabled rows see the identity), so one pipeline serves any mix of
per-request settings; ``SamplerFlags`` gates whole stage groups, so an
all-greedy batch runs the argmax alone. ``build_sampling_arrays`` packs the
host side (numpy, field for field as ``aphrodite_tpu/sample/metadata.py:
119-296``, the unseeded seed rule ``base_seed + r * 7919`` included: a
request's tokens depend on it) and ``SamplingMetadata.from_arrays`` moves
them to the device once a wave or window.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from aphrodite_tpu_torch.sample import rng
from aphrodite_tpu_torch.sampling_params import SamplingParams, SamplingType
from aphrodite_tpu_torch.utils import next_power_of_2

MAX_BREAKERS = 16
MAX_STOP_TOKENS = 16
MAX_LOGIT_BIAS = 32
MAX_ALLOWED_TOKENS = 64


class SamplerFlags(NamedTuple):
    """Static gates of the pipeline. The all-greedy default runs the
    argmax only: no noise, no sort, no softmax beyond the chosen logprob."""
    do_top_k_p: bool = False     # full-vocab sort
    do_min_p: bool = False
    all_greedy: bool = True      # skip the noise entirely
    do_penalties: bool = False
    do_dry: bool = False
    do_ngram: bool = False
    # top-a / tfs / eta / epsilon / typical / quadratic / nsigma / dynatemp
    do_advanced: bool = False
    do_xtc: bool = False
    do_skew: bool = False
    do_temp_last: bool = False
    do_min_tokens: bool = False
    do_logit_bias: bool = False
    do_allowed: bool = False
    # Batch-global sampler_priority (SamplerID ints); () = default order.
    order: tuple = ()

    @property
    def track_tokens(self) -> bool:
        """A stage reads the token history (penalties, DRY, n-gram)."""
        return self.do_penalties or self.do_dry or self.do_ngram


@dataclass(frozen=True)
class SamplingMetadata:
    # -- token history (only filled when penalties/dry/ngram are on) --------
    token_seq: torch.Tensor      # [R, L] int32, padded with vocab_size
    prompt_len: torch.Tensor     # [R] int32
    total_len: torch.Tensor      # [R] int32
    # -- per-row parameters -------------------------------------------------
    temperature: torch.Tensor    # [R] f32 (1.0 for greedy rows)
    dynatemp_min: torch.Tensor
    dynatemp_max: torch.Tensor
    dynatemp_exp: torch.Tensor
    top_p: torch.Tensor
    top_k: torch.Tensor          # [R] int32 (0 => disabled)
    top_a: torch.Tensor
    min_p: torch.Tensor
    tfs: torch.Tensor
    eta_cutoff: torch.Tensor     # already scaled to probability units
    epsilon_cutoff: torch.Tensor
    typical_p: torch.Tensor
    smoothing_factor: torch.Tensor
    smoothing_curve: torch.Tensor
    xtc_threshold: torch.Tensor
    xtc_probability: torch.Tensor
    nsigma: torch.Tensor
    skew: torch.Tensor
    presence_penalty: torch.Tensor
    frequency_penalty: torch.Tensor
    repetition_penalty: torch.Tensor
    # -- DRY ----------------------------------------------------------------
    dry_multiplier: torch.Tensor
    dry_base: torch.Tensor
    dry_allowed: torch.Tensor    # [R] int32
    dry_range: torch.Tensor      # [R] int32 (0 = unlimited)
    dry_breakers: torch.Tensor   # [R, MAX_BREAKERS] int32, pad -1
    no_repeat_ngram: torch.Tensor  # [R] int32 (0 = disabled)
    # -- min-tokens / stops / bias ------------------------------------------
    min_tokens: torch.Tensor         # [R] int32 (0 = no min)
    stop_tokens: torch.Tensor        # [R, MAX_STOP_TOKENS] int32, pad -1
    bias_tokens: torch.Tensor        # [R, MAX_LOGIT_BIAS] int32, pad -1
    bias_values: torch.Tensor        # [R, MAX_LOGIT_BIAS] f32
    allowed_tokens: torch.Tensor     # [R, MAX_ALLOWED_TOKENS] int32, pad -1
    # -- sampling -----------------------------------------------------------
    is_greedy: torch.Tensor      # [R] bool
    # key = fold_in(PRNGKey(seed), out_len + step_offset), on the device.
    seeds: torch.Tensor          # [R] int64 (31-bit values)
    out_len: torch.Tensor        # [R] int32 (output length: the counter)
    # [S, R] f32: XTC's draw at step offset i < S, the uniform of
    # fold_in(key, 1) (zeros where no row asks for XTC).
    xtc_uniform: torch.Tensor

    @classmethod
    def from_arrays(cls, arrays: dict, device) -> "SamplingMetadata":
        """The packed numpy arrays of ``build_sampling_arrays`` on
        ``device``."""
        return cls(**{f.name: torch.from_numpy(arrays[f.name]).to(device)
                      for f in fields(cls)})


def build_sampling_arrays(
    reqs: Sequence[tuple[SamplingParams, list[int], int, int]],
    vocab_size: int,
    num_reqs: int,
    base_seed: int = 0,
    extra_len: int = 0,
    history_len: Optional[int] = None,
    num_steps: int = 1,
) -> tuple[dict, SamplerFlags]:
    """Pack per-request params into numpy arrays (field name -> array,
    matching SamplingMetadata's fields).

    Each element of ``reqs`` is (params, all_token_ids, prompt_len,
    output_len); output_len is the request's sample counter. ``extra_len``
    reserves room in token_seq past the longest sequence: a decode window
    appends each sampled token to the history on the device.
    ``num_steps``: the step offsets the arrays serve (a window's length).
    XTC's per-row uniform, a scalar threefry draw a step, is drawn here
    for all of them at once, on the host: in a sub-step it would be some
    700 small launches (the JAX package draws it in-graph)."""
    R = num_reqs
    f32 = lambda v: np.full((R,), v, np.float32)  # noqa: E731
    i32 = lambda v: np.full((R,), v, np.int32)  # noqa: E731

    cols = {
        "temperature": f32(1.0), "dynatemp_min": f32(0.0),
        "dynatemp_max": f32(0.0), "dynatemp_exp": f32(1.0),
        "top_p": f32(1.0), "top_k": i32(0), "top_a": f32(0.0),
        "min_p": f32(0.0), "tfs": f32(1.0), "eta_cutoff": f32(0.0),
        "epsilon_cutoff": f32(0.0), "typical_p": f32(1.0),
        "smoothing_factor": f32(0.0), "smoothing_curve": f32(1.0),
        "xtc_threshold": f32(0.0), "xtc_probability": f32(0.0),
        "nsigma": f32(0.0), "skew": f32(0.0),
        "presence_penalty": f32(0.0), "frequency_penalty": f32(0.0),
        "repetition_penalty": f32(1.0),
        "dry_multiplier": f32(0.0), "dry_base": f32(1.75),
        "dry_allowed": i32(2), "dry_range": i32(0),
        "no_repeat_ngram": i32(0),
    }
    dry_breakers = np.full((R, MAX_BREAKERS), -1, np.int32)
    stop_tokens = np.full((R, MAX_STOP_TOKENS), -1, np.int32)
    bias_tokens = np.full((R, MAX_LOGIT_BIAS), -1, np.int32)
    bias_values = np.zeros((R, MAX_LOGIT_BIAS), np.float32)
    allowed_tokens = np.full((R, MAX_ALLOWED_TOKENS), -1, np.int32)
    min_tokens = np.zeros((R,), np.int32)
    is_greedy = np.ones((R,), bool)
    seeds = np.zeros((R,), np.int64)
    out_lens = np.zeros((R,), np.int32)
    prompt_len = np.zeros((R,), np.int32)
    total_len = np.zeros((R,), np.int32)

    flags = dict.fromkeys(SamplerFlags._fields, False)
    flags["order"] = ()
    max_len = max([1] + [len(toks) for _, toks, _, _ in reqs])

    for r, (p, toks, p_len, out_len) in enumerate(reqs):
        prompt_len[r] = p_len
        total_len[r] = len(toks)
        greedy = p.sampling_type == SamplingType.GREEDY
        is_greedy[r] = greedy
        cols["temperature"][r] = p.temperature if not greedy else 1.0
        cols["top_p"][r] = p.top_p
        cols["top_k"][r] = max(p.top_k, 0)
        cols["min_p"][r] = p.min_p
        if p.top_k > 0 or p.top_p < 1.0:
            flags["do_top_k_p"] = True
        if p.min_p > 0:
            flags["do_min_p"] = True
        if p.dynatemp_min != 0.0 or p.dynatemp_max != 0.0:
            cols["dynatemp_min"][r] = p.dynatemp_min
            cols["dynatemp_max"][r] = p.dynatemp_max
            cols["dynatemp_exp"][r] = p.dynatemp_exponent
            flags["do_advanced"] = True
        for name, val, default in (
                ("top_a", p.top_a, 0.0), ("tfs", p.tfs, 1.0),
                ("typical_p", p.typical_p, 1.0),
                ("smoothing_factor", p.smoothing_factor, 0.0),
                ("nsigma", p.nsigma, 0.0)):
            if val != default:
                cols[name][r] = val
                flags["do_advanced"] = True
        # eta/epsilon arrive in units of 1e-4 (reference convention).
        if p.eta_cutoff > 0:
            cols["eta_cutoff"][r] = p.eta_cutoff * 1e-4
            flags["do_advanced"] = True
        if p.epsilon_cutoff > 0:
            cols["epsilon_cutoff"][r] = p.epsilon_cutoff * 1e-4
            flags["do_advanced"] = True
        cols["smoothing_curve"][r] = p.smoothing_curve
        if p.xtc_probability > 0:
            cols["xtc_threshold"][r] = p.xtc_threshold
            cols["xtc_probability"][r] = p.xtc_probability
            flags["do_xtc"] = True
        if p.skew != 0.0:
            cols["skew"][r] = p.skew
            flags["do_skew"] = True
        if p.temperature_last and not greedy:
            flags["do_temp_last"] = True
        if (p.presence_penalty != 0 or p.frequency_penalty != 0
                or p.repetition_penalty != 1.0):
            cols["presence_penalty"][r] = p.presence_penalty
            cols["frequency_penalty"][r] = p.frequency_penalty
            cols["repetition_penalty"][r] = p.repetition_penalty
            flags["do_penalties"] = True
        if p.dry_multiplier > 0:
            cols["dry_multiplier"][r] = p.dry_multiplier
            cols["dry_base"][r] = p.dry_base
            cols["dry_allowed"][r] = p.dry_allowed_length
            cols["dry_range"][r] = p.dry_range
            brk = p.dry_sequence_breaker_ids[:MAX_BREAKERS]
            dry_breakers[r, :len(brk)] = brk
            flags["do_dry"] = True
        if p.no_repeat_ngram_size > 0:
            cols["no_repeat_ngram"][r] = p.no_repeat_ngram_size
            flags["do_ngram"] = True
        out_lens[r] = out_len
        if p.min_tokens > 0 and out_len < p.min_tokens:
            ids = sorted(p.all_stop_token_ids)[:MAX_STOP_TOKENS]
            if ids:
                stop_tokens[r, :len(ids)] = ids
                min_tokens[r] = p.min_tokens
                flags["do_min_tokens"] = True
        if p.allowed_token_ids:
            ids = list(p.allowed_token_ids)[:MAX_ALLOWED_TOKENS]
            allowed_tokens[r, :len(ids)] = ids
            flags["do_allowed"] = True
        if p.logit_bias:
            items = list(p.logit_bias.items())[:MAX_LOGIT_BIAS]
            for j, (tok, val) in enumerate(items):
                bias_tokens[r, j] = int(tok)
                bias_values[r, j] = float(val)
            flags["do_logit_bias"] = True
        seed = p.seed if p.seed is not None else (base_seed + r * 7919)
        seeds[r] = seed & 0x7fffffff

    for p, _, _, _ in reqs:
        if p.sampler_priority is not None:
            flags["order"] = tuple(int(x) for x in p.sampler_priority)
            break
    # The JAX package's flags start False and never set all_greedy, so it
    # always runs the sampled branch, where greedy rows take the argmax of
    # the processed logits. With every row greedy and no stage on, that
    # branch gives the argmax branch's tokens and logprobs; only then is
    # the batch all-greedy here (the argmax alone, no noise).
    flags["all_greedy"] = bool(is_greedy.all()) and not any(flags.values())
    sampler_flags = SamplerFlags(**flags)
    if sampler_flags.track_tokens:
        L = next_power_of_2(max(max_len + extra_len, history_len or 1))
        token_seq = np.full((R, L), vocab_size, np.int32)
        for r, (_, toks, _, _) in enumerate(reqs):
            token_seq[r, :len(toks)] = toks
    else:
        token_seq = np.full((R, 1), vocab_size, np.int32)

    xtc_uniform = np.zeros((num_steps, R), np.float32)
    if sampler_flags.do_xtc:
        counters = (out_lens[None, :].astype(np.int64)
                    + np.arange(num_steps)[:, None]).reshape(-1)
        key_xtc, _ = rng.sample_keys(
            torch.from_numpy(np.tile(seeds, num_steps)),
            torch.from_numpy(counters))
        xtc_uniform = rng.uniform(key_xtc).numpy().reshape(num_steps, R)

    arrays = dict(
        token_seq=token_seq,
        xtc_uniform=xtc_uniform,
        prompt_len=prompt_len,
        total_len=total_len,
        dry_breakers=dry_breakers,
        min_tokens=min_tokens,
        stop_tokens=stop_tokens,
        bias_tokens=bias_tokens,
        bias_values=bias_values,
        allowed_tokens=allowed_tokens,
        is_greedy=is_greedy,
        seeds=seeds,
        out_len=out_lens,
        **cols)
    return arrays, sampler_flags
