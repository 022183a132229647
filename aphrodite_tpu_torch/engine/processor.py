"""Input processing: token-id prompt -> validated Request.

The port has no tokenizer: prompts are token-id lists, or dicts with
``prompt_token_ids`` and, for a multimodal model, ``multi_modal_data``
(``{"image": ...}``: one image or a list, as the model's adapter takes
them), whose images are preprocessed and whose placeholders are expanded
here (``aphrodite_tpu/engine/processor.py:117-162``).
"""
from __future__ import annotations

from typing import Union

from aphrodite_tpu_torch.config import EngineConfig
from aphrodite_tpu_torch.core.request import Request
from aphrodite_tpu_torch.multimodal import MMInputs, get_mm_adapter
from aphrodite_tpu_torch.sample.metadata import MAX_ALLOWED_TOKENS
from aphrodite_tpu_torch.sample.sampler import check_supported
from aphrodite_tpu_torch.sampling_params import SamplingParams

PromptType = Union[list[int], dict]


class Processor:

    def __init__(self, config: EngineConfig) -> None:
        self.config = config
        self.max_model_len = config.scheduler_config.max_model_len
        self.vocab_size = config.model_config.vocab_size
        self.mm_adapter = get_mm_adapter(config.model_config.hf_config)

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
        mm_inputs = None
        mm_data = (prompt.get("multi_modal_data")
                   if isinstance(prompt, dict) else None)
        if mm_data:
            if self.mm_adapter is None:
                raise ValueError(f"request {request_id}: multi_modal_data "
                                 "given but the model is not multimodal")
            media = mm_data.get(self.mm_adapter.media_key)
            if media is None:
                raise ValueError(
                    f"request {request_id}: the model expects "
                    f"'{self.mm_adapter.media_key}' in multi_modal_data")
            pv = self.mm_adapter.preprocess(media)
            token_ids, spans = self.mm_adapter.expand_prompt(token_ids,
                                                             pv.shape[0])
            mm_inputs = MMInputs(pixel_values=pv, spans=spans)
        if not token_ids:
            raise ValueError(f"request {request_id}: empty prompt")
        if len(token_ids) >= self.max_model_len:
            raise ValueError(
                f"request {request_id}: prompt length {len(token_ids)} "
                f"exceeds max_model_len {self.max_model_len}")
        if params.max_tokens is None:
            params = params.clone()
            params.max_tokens = self.max_model_len - len(token_ids)
        if params.allowed_token_ids is not None:
            if not params.allowed_token_ids:
                raise ValueError("allowed_token_ids must be non-empty")
            if len(params.allowed_token_ids) > MAX_ALLOWED_TOKENS:
                raise ValueError(f"allowed_token_ids supports up to "
                                 f"{MAX_ALLOWED_TOKENS} ids")
            if any(t < 0 or t >= self.vocab_size
                   for t in params.allowed_token_ids):
                raise ValueError("allowed_token_ids out of vocab range")
        return Request(request_id=request_id, prompt_token_ids=token_ids,
                       sampling_params=params, mm_inputs=mm_inputs)
