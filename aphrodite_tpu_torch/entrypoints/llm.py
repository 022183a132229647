"""Offline batch inference API of the PyTorch port."""
from __future__ import annotations

from typing import Any, Optional, Sequence, Union

from aphrodite_tpu_torch.config import (CacheConfig, DeviceConfig,
                                        EngineConfig, LoadConfig, ModelConfig,
                                        SchedulerConfig)
from aphrodite_tpu_torch.engine.llm_engine import LLMEngine
from aphrodite_tpu_torch.engine.processor import PromptType
from aphrodite_tpu_torch.outputs import RequestOutput
from aphrodite_tpu_torch.sampling_params import SamplingParams
from aphrodite_tpu_torch.utils import Counter


def build_engine_config(
    model: str,
    *,
    tokenizer: Optional[str] = None,
    dtype: str = "bfloat16",
    seed: int = 0,
    max_model_len: Optional[int] = None,
    quantization: Optional[str] = None,
    quantize_lm_head: bool = False,
    hf_config: Any = None,
    kv_cache_dtype: str = "auto",
    block_size: int = 32,
    num_kv_blocks: Optional[int] = None,
    max_num_seqs: int = 128,
    max_num_batched_tokens: int = 2048,
    device: str = "auto",
    load_format: str = "dummy",
    decode_window: int = 64,
) -> EngineConfig:
    mc = ModelConfig(model=model, tokenizer=tokenizer, dtype=dtype,
                     seed=seed, max_model_len=max_model_len,
                     quantization=quantization,
                     quantize_lm_head=quantize_lm_head, hf_config=hf_config)
    return EngineConfig(
        model_config=mc,
        cache_config=CacheConfig(block_size=block_size,
                                 num_blocks=num_kv_blocks,
                                 cache_dtype=kv_cache_dtype),
        scheduler_config=SchedulerConfig(
            max_num_seqs=max_num_seqs,
            max_num_batched_tokens=max_num_batched_tokens,
            max_model_len=max_model_len or mc.max_model_len),
        device_config=DeviceConfig(device=device),
        load_config=LoadConfig(load_format=load_format),
        decode_window=decode_window,
    )


class LLM:
    """Synchronous batched generation over an in-process engine. Runs on
    the CUDA card unless ``device="cpu"`` is passed."""

    def __init__(self, model: str, **kwargs) -> None:
        self.engine = LLMEngine(build_engine_config(model, **kwargs))
        self._counter = Counter()

    def generate(
        self,
        prompts: Union[PromptType, Sequence[PromptType]],
        sampling_params: Union[SamplingParams, Sequence[SamplingParams],
                               None] = None,
    ) -> list[RequestOutput]:
        if isinstance(prompts, dict) or (
                isinstance(prompts, list) and prompts
                and isinstance(prompts[0], int)):
            prompts = [prompts]
        n = len(prompts)
        if sampling_params is None:
            sampling_params = SamplingParams(temperature=0.0)
        if isinstance(sampling_params, SamplingParams):
            sampling_params = [sampling_params] * n
        if len(sampling_params) != n:
            raise ValueError("prompts / sampling_params length mismatch")

        order: list[str] = []
        for prompt, params in zip(prompts, sampling_params):
            rid = str(next(self._counter))
            order.append(rid)
            self.engine.add_request(rid, prompt, params)
        # Request id -> completion index -> merged output (n > 1 children
        # arrive under their parent's id, each with its index).
        done: dict[str, dict[int, RequestOutput]] = {}
        while self.engine.has_unfinished_requests():
            for out in self.engine.step():
                slot = done.setdefault(out.request_id, {})
                idx = out.outputs[0].index
                if idx in slot:
                    slot[idx].add(out)
                else:
                    slot[idx] = out
        return [_finalize(done[rid]) for rid in order]


def _finalize(slot: dict[int, RequestOutput]) -> RequestOutput:
    """One RequestOutput of a request's per-index outputs."""
    first = slot[min(slot)]
    return RequestOutput(
        request_id=first.request_id,
        prompt=first.prompt,
        prompt_token_ids=first.prompt_token_ids,
        prompt_logprobs=next((o.prompt_logprobs for o in slot.values()
                              if o.prompt_logprobs), None),
        outputs=[slot[i].outputs[0] for i in sorted(slot)],
        finished=all(o.finished for o in slot.values()),
        num_cached_tokens=first.num_cached_tokens)
