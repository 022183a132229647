"""Scheduler <-> model-runner interchange types."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from aphrodite_tpu_torch.sampling_params import SamplingParams


@dataclass
class NewRequestData:
    """A request entering the runner's persistent batch for the first time."""
    req_id: str
    prompt_token_ids: list[int]
    sampling_params: SamplingParams
    block_ids: list[int]
    num_computed_tokens: int  # prefix-cache hit length


@dataclass
class CachedRequestData:
    """Delta updates for requests the runner already tracks."""
    req_ids: list[str] = field(default_factory=list)
    new_block_ids: list[list[int]] = field(default_factory=list)
    resumed_from_preemption: list[bool] = field(default_factory=list)
    # For resumed requests the runner must resync the full token list.
    all_token_ids: list[Optional[list[int]]] = field(default_factory=list)
    num_computed_tokens: list[int] = field(default_factory=list)


@dataclass
class SchedulerOutput:
    scheduled_new_reqs: list[NewRequestData]
    scheduled_cached_reqs: CachedRequestData
    # req_id -> number of tokens to run through the model this step.
    num_scheduled_tokens: dict[str, int]
    total_num_scheduled_tokens: int
    # Requests that finished/aborted since last step (purge from runner).
    finished_req_ids: set[str]

    @property
    def is_empty(self) -> bool:
        return self.total_num_scheduled_tokens == 0


@dataclass
class ModelRunnerOutput:
    """What the runner hands back after one step."""
    # Order matches the runner's batch, restricted to scheduled reqs.
    req_ids: list[str]
    # Per request: sampled token ids (>1 for a decode window, [] if this
    # step only advanced a prefill chunk).
    sampled_token_ids: list[list[int]]
    # Per request per sampled token: {token_id: logprob} dicts (optional).
    logprobs: Optional[list[Optional[list[dict[int, float]]]]] = None
