"""Synchronous engine frontend: processor -> core -> output processor."""
from __future__ import annotations

from typing import Optional

from aphrodite_tpu_torch.config import EngineConfig
from aphrodite_tpu_torch.engine.core import EngineCore
from aphrodite_tpu_torch.engine.output_processor import OutputProcessor
from aphrodite_tpu_torch.engine.processor import Processor, PromptType
from aphrodite_tpu_torch.outputs import RequestOutput
from aphrodite_tpu_torch.sampling_params import SamplingParams


class LLMEngine:

    def __init__(self, config: EngineConfig) -> None:
        if config.model_config.tokenizer != "unused":
            raise NotImplementedError(
                "tokenizers are not ported: pass tokenizer='unused' and "
                "token-id prompts")
        self.config = config
        self.processor = Processor(config)
        self.core = EngineCore(config)
        self.output_processor = OutputProcessor()

    def add_request(self, request_id: str, prompt: PromptType,
                    params: Optional[SamplingParams] = None) -> None:
        req = self.processor.process(request_id, prompt,
                                     params or SamplingParams(temperature=0))
        self.core.scheduler.add_request(req)
        self.output_processor.add_request(req)

    def step(self) -> list[RequestOutput]:
        return self.output_processor.process_outputs(self.core.step())

    def reset_prefix_cache(self) -> bool:
        """Forget every cached prefix (False while requests run)."""
        return self.core.reset_prefix_cache()

    def has_unfinished_requests(self) -> bool:
        return (self.core.scheduler.has_unfinished_requests()
                or self.output_processor.has_requests())
