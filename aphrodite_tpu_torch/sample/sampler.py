"""Greedy sampling, the only mode the port has.

``greedy_sample`` matches the JAX sampler's all-greedy branch
(``aphrodite_tpu/sample/sampler.py:480-483``): the argmax token (first
index on ties, as ``jnp.argmax``) and the fp32 log-softmax logprob of that
token. ``check_supported`` rejects every ``SamplingParams`` that would need
anything else, so a request never silently runs greedy.
"""
from __future__ import annotations

import torch

from aphrodite_tpu_torch.sampling_params import SamplingParams

# Fields that may differ from their defaults: they do not change which
# token greedy decoding picks. top_p/top_k/min_p are neutralized by
# SamplingParams itself when temperature is 0.
_ALLOWED = {"temperature", "top_p", "top_k", "min_p", "seed", "stop_token_ids",
            "ignore_eos", "max_tokens", "detokenize", "skip_special_tokens",
            "spaces_between_special_tokens", "include_stop_str_in_output",
            "logprobs", "extra_args", "sampler_priority"}
_DEFAULTS = SamplingParams(temperature=0.0)


def check_supported(params: SamplingParams) -> None:
    if params.temperature >= 1e-5:
        raise NotImplementedError(
            "only greedy sampling (temperature=0) is ported; "
            f"temperature={params.temperature}")
    if params.logprobs:
        raise NotImplementedError(
            "top-k logprobs are not ported (logprobs=0 returns the chosen "
            "token's logprob)")
    for name, default in vars(_DEFAULTS).items():
        if name not in _ALLOWED and getattr(params, name) != default:
            raise NotImplementedError(
                f"SamplingParams.{name}={getattr(params, name)!r} is not "
                "ported (greedy sampling only)")


def greedy_sample(logits: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """logits [R, V] float32 -> (tokens [R] int64, logprob [R] float32)."""
    tokens = torch.argmax(logits, dim=-1)
    logprob = torch.log_softmax(logits.float(), dim=-1).gather(
        1, tokens[:, None])[:, 0]
    return tokens, logprob
