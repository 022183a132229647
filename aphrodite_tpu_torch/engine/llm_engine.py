"""Synchronous engine frontend: processor -> core -> output processor."""
from __future__ import annotations

from typing import Optional, Union

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
        # parent request id -> the indices of its unfinished children
        # (n > 1 fan-out); the entry goes when the last child finishes.
        self._fanout: dict[str, set[int]] = {}

    def add_request(self, request_id: str, prompt: PromptType,
                    params: Optional[SamplingParams] = None) -> None:
        params = params or SamplingParams(temperature=0)
        if params.n == 1:
            req = self.processor.process(request_id, prompt, params)
            self.core.scheduler.add_request(req)
            self.output_processor.add_request(req)
            return
        # n > 1: children "{id}-cld-{i}" share the prompt (the prefix cache
        # makes their prefills nearly free); a seeded parent gives child i
        # seed + i (``llm_engine.py:49-71``).
        self._fanout[request_id] = set(range(params.n))
        for i in range(params.n):
            child = params.clone()
            child.n = 1
            if params.seed is not None:
                child.seed = params.seed + i
            req = self.processor.process(f"{request_id}-cld-{i}", prompt,
                                         child)
            self.core.scheduler.add_request(req)
            self.output_processor.add_request(req, parent_id=request_id,
                                              index=i)

    def abort_request(self, request_ids: Union[str, list[str]]) -> None:
        """Abort requests; a parent's id aborts all its children."""
        if isinstance(request_ids, str):
            request_ids = [request_ids]
        expanded = []
        for rid in request_ids:
            live = self._fanout.pop(rid, None)
            if live is not None:
                expanded.extend(f"{rid}-cld-{i}" for i in sorted(live))
            else:
                expanded.append(rid)
        self.core.abort_requests(expanded)
        for rid in expanded:
            self.output_processor.abort_request(rid)

    def step(self) -> list[RequestOutput]:
        outputs = self.output_processor.process_outputs(self.core.step())
        for out in outputs:
            live = self._fanout.get(out.request_id)
            if live is not None and out.finished:
                live.discard(out.outputs[0].index)
                if not live:
                    del self._fanout[out.request_id]
        return outputs

    def reset_prefix_cache(self) -> bool:
        """Forget every cached prefix (False while requests run)."""
        return self.core.reset_prefix_cache()

    def has_unfinished_requests(self) -> bool:
        return (self.core.scheduler.has_unfinished_requests()
                or self.output_processor.has_requests())
