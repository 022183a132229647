"""Engine-core request state."""
from __future__ import annotations

import enum
from typing import TYPE_CHECKING, Optional

from aphrodite_tpu_torch.sampling_params import SamplingParams

if TYPE_CHECKING:
    from aphrodite_tpu_torch.multimodal import MMInputs


class RequestStatus(enum.IntEnum):
    WAITING = 0
    RUNNING = 1
    PREEMPTED = 2
    FINISHED_STOPPED = 3
    FINISHED_LENGTH_CAPPED = 4
    FINISHED_ABORTED = 5
    FINISHED_IGNORED = 6

    @staticmethod
    def is_finished(status: "RequestStatus") -> bool:
        return status >= RequestStatus.FINISHED_STOPPED


FINISH_REASON = {
    RequestStatus.FINISHED_STOPPED: "stop",
    RequestStatus.FINISHED_LENGTH_CAPPED: "length",
    RequestStatus.FINISHED_ABORTED: "abort",
    RequestStatus.FINISHED_IGNORED: "length",
}


class Request:

    def __init__(
        self,
        request_id: str,
        prompt_token_ids: list[int],
        sampling_params: SamplingParams,
        eos_token_id: Optional[int] = None,
        mm_inputs: Optional["MMInputs"] = None,
    ) -> None:
        self.request_id = request_id
        self.prompt_token_ids = list(prompt_token_ids)
        self.sampling_params = sampling_params
        self.eos_token_id = eos_token_id
        # Images of the prompt (``multimodal.MMInputs``) or None; mm_hash
        # feeds the KV page hashes, so that images tell apart prompts of
        # equal placeholder ids (``core/request.py:58-61``).
        self.mm_inputs = mm_inputs
        self.mm_hash = mm_inputs.content_hash() if mm_inputs else None
        self.status = RequestStatus.WAITING
        self.stop_reason: Optional[object] = None

        self.output_token_ids: list[int] = []
        # All tokens (prompt + output); kept as one list for cheap slicing.
        self._all_token_ids: list[int] = list(prompt_token_ids)
        self.num_computed_tokens = 0
        # Prefix-cache hit length at admission (for num_cached_tokens).
        self.num_cached_tokens = 0

    # ------------------------------------------------------------------ tokens
    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt_token_ids)

    @property
    def num_output_tokens(self) -> int:
        return len(self.output_token_ids)

    @property
    def num_tokens(self) -> int:
        return len(self._all_token_ids)

    @property
    def all_token_ids(self) -> list[int]:
        return self._all_token_ids

    def append_output_token_ids(self, token_ids: list[int]) -> None:
        self.output_token_ids.extend(token_ids)
        self._all_token_ids.extend(token_ids)

    @property
    def is_finished(self) -> bool:
        return RequestStatus.is_finished(self.status)

    @property
    def max_tokens(self) -> int:
        mt = self.sampling_params.max_tokens
        return mt if mt is not None else 2**31

    def get_finish_reason(self) -> Optional[str]:
        return FINISH_REASON.get(self.status)
