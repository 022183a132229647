"""Output processing: EngineCoreOutput -> RequestOutput deltas.

Without a tokenizer there is no text: outputs carry token ids (and the
chosen tokens' logprobs when asked for).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from aphrodite_tpu_torch.core.request import Request
from aphrodite_tpu_torch.core.scheduler import EngineCoreOutput
from aphrodite_tpu_torch.outputs import (CompletionOutput, Logprob,
                                         RequestOutput)


@dataclass
class RequestOutputState:
    request_id: str
    prompt_token_ids: list[int]
    logprobs: Optional[list[dict]] = None
    cumulative_logprob: Optional[float] = None


class OutputProcessor:

    def __init__(self) -> None:
        self.states: dict[str, RequestOutputState] = {}

    def add_request(self, request: Request) -> None:
        self.states[request.request_id] = RequestOutputState(
            request_id=request.request_id,
            prompt_token_ids=request.prompt_token_ids,
            logprobs=([] if request.sampling_params.logprobs is not None
                      else None))

    def process_outputs(self, core_outputs: list[EngineCoreOutput]
                        ) -> list[RequestOutput]:
        outputs: list[RequestOutput] = []
        for eco in core_outputs:
            st = self.states.get(eco.req_id)
            if st is None:
                continue
            new_tokens = list(eco.new_token_ids)
            new_lps = None
            if st.logprobs is not None and eco.logprobs:
                new_lps = []
                for tok, d in zip(new_tokens, eco.logprobs):
                    new_lps.append({t: Logprob(logprob=v)
                                    for t, v in d.items()})
                    st.cumulative_logprob = ((st.cumulative_logprob or 0.0)
                                             + d[tok])
                st.logprobs.extend(new_lps)
            if eco.finished:
                self.states.pop(eco.req_id, None)
            outputs.append(RequestOutput(
                request_id=st.request_id,
                prompt=None,
                prompt_token_ids=st.prompt_token_ids,
                outputs=[CompletionOutput(
                    index=0,
                    text="",
                    token_ids=new_tokens,
                    cumulative_logprob=st.cumulative_logprob,
                    logprobs=new_lps,
                    finish_reason=eco.finish_reason if eco.finished
                    else None,
                    stop_reason=eco.stop_reason if eco.finished else None)],
                finished=eco.finished,
                num_cached_tokens=eco.num_cached_tokens))
        return outputs

    def has_requests(self) -> bool:
        return bool(self.states)
