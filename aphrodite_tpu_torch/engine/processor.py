"""Input processing: token-id prompt -> validated Request.

The port has no tokenizer: prompts are token-id lists, or dicts with
``prompt_token_ids``.
"""
from __future__ import annotations

from typing import Union

from aphrodite_tpu_torch.config import EngineConfig
from aphrodite_tpu_torch.core.request import Request
from aphrodite_tpu_torch.sample.sampler import check_supported
from aphrodite_tpu_torch.sampling_params import SamplingParams

PromptType = Union[list[int], dict]


class Processor:

    def __init__(self, config: EngineConfig) -> None:
        self.config = config
        self.max_model_len = config.scheduler_config.max_model_len

    def process(self, request_id: str, prompt: PromptType,
                params: SamplingParams) -> Request:
        check_supported(params)
        if isinstance(prompt, dict) and "prompt_token_ids" in prompt:
            token_ids = list(prompt["prompt_token_ids"])
        elif isinstance(prompt, (list, tuple)):
            token_ids = list(prompt)
        else:
            raise NotImplementedError(
                f"request {request_id}: only token-id prompts are ported "
                "(no tokenizer)")
        if not token_ids:
            raise ValueError(f"request {request_id}: empty prompt")
        if len(token_ids) >= self.max_model_len:
            raise ValueError(
                f"request {request_id}: prompt length {len(token_ids)} "
                f"exceeds max_model_len {self.max_model_len}")
        if params.max_tokens is None:
            params = params.clone()
            params.max_tokens = self.max_model_len - len(token_ids)
        return Request(request_id=request_id, prompt_token_ids=token_ids,
                       sampling_params=params)
