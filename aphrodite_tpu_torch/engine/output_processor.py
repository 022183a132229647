"""Output processing: EngineCoreOutput -> RequestOutput deltas, and the
aggregation of ``n > 1`` children under their parent's id (the JAX
package's ``engine/output_processor.py`` without detokenization and stop
strings, which wait for the tokenizer).

Without a tokenizer there is no text: outputs carry token ids, their
logprobs (the chosen token's and the top ``logprobs``) and the prompt
logprobs when asked for.
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
    parent_id: Optional[str] = None  # for n > 1 fan-out
    index: int = 0
    logprobs: Optional[list[dict]] = None
    cumulative_logprob: Optional[float] = None


class OutputProcessor:

    def __init__(self) -> None:
        self.states: dict[str, RequestOutputState] = {}

    def add_request(self, request: Request, parent_id: Optional[str] = None,
                    index: int = 0) -> None:
        self.states[request.request_id] = RequestOutputState(
            request_id=request.request_id,
            prompt_token_ids=request.prompt_token_ids,
            parent_id=parent_id,
            index=index,
            logprobs=([] if request.sampling_params.logprobs is not None
                      else None))

    def abort_request(self, request_id: str) -> None:
        self.states.pop(request_id, None)

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
            plp = None
            if eco.prompt_logprobs:
                plp = [None if d is None else
                       {t: Logprob(logprob=v) for t, v in d.items()}
                       for d in eco.prompt_logprobs]
            outputs.append(RequestOutput(
                request_id=st.parent_id or st.request_id,
                prompt=None,
                prompt_token_ids=st.prompt_token_ids,
                prompt_logprobs=plp,
                outputs=[CompletionOutput(
                    index=st.index,
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
