"""Request/completion output types returned by the engine (the JAX
package's ``outputs.py`` without its pooling and metrics types)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Logprob:
    logprob: float
    rank: Optional[int] = None
    decoded_token: Optional[str] = None


# {token_id: Logprob} per generated position.
LogprobsDict = dict[int, Logprob]


@dataclass
class CompletionOutput:
    index: int
    text: str
    token_ids: list[int]
    cumulative_logprob: Optional[float] = None
    logprobs: Optional[list[LogprobsDict]] = None
    finish_reason: Optional[str] = None  # "stop" | "length" | "abort"
    stop_reason: Optional[object] = None

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None


@dataclass
class RequestOutput:
    request_id: str
    prompt: Optional[str]
    prompt_token_ids: list[int]
    outputs: list[CompletionOutput]
    finished: bool
    prompt_logprobs: Optional[list[Optional[LogprobsDict]]] = None
    num_cached_tokens: int = 0

    def add(self, other: "RequestOutput") -> None:
        """Merge a later incremental output into this one (offline API)."""
        self.finished = other.finished
        if other.prompt_logprobs and not self.prompt_logprobs:
            self.prompt_logprobs = other.prompt_logprobs
        for o, n in zip(self.outputs, other.outputs):
            o.text += n.text
            o.token_ids.extend(n.token_ids)
            o.finish_reason = n.finish_reason
            o.stop_reason = n.stop_reason
            if n.cumulative_logprob is not None:
                o.cumulative_logprob = n.cumulative_logprob
            if n.logprobs is not None:
                if o.logprobs is None:
                    o.logprobs = []
                o.logprobs.extend(n.logprobs)
