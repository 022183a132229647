"""Token-budget continuous-batching scheduler.

One unified loop with no prefill/decode phase distinction: every request
asks for ``num_tokens - num_computed_tokens`` tokens each step, capped by
the shared token budget (chunked prefill falls out naturally). Preemption
is recompute-only. FCFS within each of running/waiting.

Copied from the JAX package's ``core/scheduler.py`` without what the port's
synchronous offline engine does not have: async steps, continuation
windows, speculative decoding, priority scheduling, prefill quanta and
aborts.
"""
from __future__ import annotations

from collections import deque

from aphrodite_tpu_torch.config import CacheConfig, SchedulerConfig
from aphrodite_tpu_torch.core.kv_cache_manager import KVCacheManager
from aphrodite_tpu_torch.core.request import Request, RequestStatus
from aphrodite_tpu_torch.core.sched_output import (CachedRequestData,
                                                   ModelRunnerOutput,
                                                   NewRequestData,
                                                   SchedulerOutput)
from aphrodite_tpu_torch.utils import logger


class EngineCoreOutput:
    """Per-request result of one engine step (token deltas + finish state)."""

    __slots__ = ("req_id", "new_token_ids", "finished", "finish_reason",
                 "stop_reason", "logprobs", "num_cached_tokens")

    def __init__(self, req_id, new_token_ids, finished, finish_reason=None,
                 stop_reason=None, logprobs=None, num_cached_tokens=0):
        self.req_id = req_id
        self.new_token_ids = new_token_ids
        self.finished = finished
        self.finish_reason = finish_reason
        self.stop_reason = stop_reason
        self.logprobs = logprobs
        self.num_cached_tokens = num_cached_tokens


class Scheduler:

    def __init__(self, scheduler_config: SchedulerConfig,
                 cache_config: CacheConfig,
                 num_lookahead_tokens: int = 0) -> None:
        self.config = scheduler_config
        self.cache_config = cache_config
        if cache_config.num_blocks is None:
            raise ValueError(
                "cache_config.num_blocks must be set before scheduler "
                "creation")
        self.kv = KVCacheManager(cache_config.num_blocks,
                                 cache_config.block_size,
                                 cache_config.enable_prefix_caching)
        self.block_size = cache_config.block_size
        # Extra empty slots to allocate per request per step (the decode
        # window's lookahead).
        self.num_lookahead_tokens = num_lookahead_tokens

        self.waiting: deque[Request] = deque()
        self.running: list[Request] = []
        self.num_preemptions = 0
        self.requests: dict[str, Request] = {}
        # Finished since the last schedule() — runner purge list.
        self._finished_req_ids: set[str] = set()

    # ------------------------------------------------------------------ intake
    def add_request(self, request: Request) -> None:
        if len(request.prompt_token_ids) > self.config.max_model_len:
            request.status = RequestStatus.FINISHED_IGNORED
            self._finished_req_ids.add(request.request_id)
            return
        self.requests[request.request_id] = request
        self.waiting.append(request)

    def _free_request(self, request: Request) -> None:
        self.kv.free(request)
        self.running.remove(request)
        self._finished_req_ids.add(request.request_id)
        del self.requests[request.request_id]

    # ---------------------------------------------------------------- schedule
    def schedule(self) -> SchedulerOutput:
        budget = self.config.max_num_batched_tokens
        num_scheduled: dict[str, int] = {}
        new_reqs: list[NewRequestData] = []
        cached = CachedRequestData()
        preempted: set[str] = set()

        # -- 1. running requests ------------------------------------------
        idx = 0
        while idx < len(self.running) and budget > 0:
            req = self.running[idx]
            num_new = min(req.num_tokens - req.num_computed_tokens, budget,
                          self.config.max_model_len - req.num_computed_tokens)
            if num_new <= 0:
                idx += 1
                continue
            while True:
                new_blocks = self.kv.allocate_slots(
                    req, num_new,
                    num_lookahead_tokens=self.num_lookahead_tokens)
                if new_blocks is not None:
                    break
                # Preempt the newest running request (recompute-only).
                victim = self.running[-1]
                self._preempt(victim)
                preempted.add(victim.request_id)
                if victim is req:
                    # Can't even fit ourselves: preempted self, stop.
                    break
            if new_blocks is None:
                break
            num_scheduled[req.request_id] = num_new
            budget -= num_new
            cached.req_ids.append(req.request_id)
            cached.new_block_ids.append([b.block_id for b in new_blocks])
            cached.resumed_from_preemption.append(False)
            cached.all_token_ids.append(None)
            cached.num_computed_tokens.append(req.num_computed_tokens)
            idx += 1

        # -- 2. waiting requests ------------------------------------------
        while (self.waiting and budget > 0
               and len(self.running) < self.config.max_num_seqs):
            req = self.waiting[0]
            if req.request_id in preempted:
                # Don't resume a request we just preempted this same step.
                break
            computed_blocks, num_computed = self.kv.get_computed_blocks(req)
            num_new = min(req.num_tokens - num_computed, budget)
            if num_new <= 0:
                break
            new_blocks = self.kv.allocate_slots(
                req, num_new, new_computed_blocks=computed_blocks,
                num_lookahead_tokens=self.num_lookahead_tokens)
            if new_blocks is None:
                break  # out of pages: leave in waiting
            self.waiting.popleft()
            resumed = req.status == RequestStatus.PREEMPTED
            req.status = RequestStatus.RUNNING
            req.num_computed_tokens = num_computed
            if req.num_cached_tokens == 0:
                req.num_cached_tokens = num_computed
            self.running.append(req)
            num_scheduled[req.request_id] = num_new
            budget -= num_new
            all_block_ids = self.kv.get_block_ids(req.request_id)
            if resumed:
                cached.req_ids.append(req.request_id)
                cached.new_block_ids.append(all_block_ids)
                cached.resumed_from_preemption.append(True)
                cached.all_token_ids.append(list(req.all_token_ids))
                cached.num_computed_tokens.append(num_computed)
            else:
                new_reqs.append(
                    NewRequestData(
                        req_id=req.request_id,
                        prompt_token_ids=req.prompt_token_ids,
                        sampling_params=req.sampling_params,
                        block_ids=all_block_ids,
                        num_computed_tokens=num_computed))

        finished_ids = self._finished_req_ids
        self._finished_req_ids = set()
        return SchedulerOutput(
            scheduled_new_reqs=new_reqs,
            scheduled_cached_reqs=cached,
            num_scheduled_tokens=num_scheduled,
            total_num_scheduled_tokens=sum(num_scheduled.values()),
            finished_req_ids=finished_ids)

    def _preempt(self, req: Request) -> None:
        self.num_preemptions += 1
        self.running.remove(req)
        self.kv.free(req)
        req.status = RequestStatus.PREEMPTED
        req.num_computed_tokens = 0
        self.waiting.appendleft(req)
        logger.debug("preempted request %s", req.request_id)

    # ------------------------------------------------------------ post-process
    def update_from_output(self, sched_out: SchedulerOutput,
                           runner_out: ModelRunnerOutput
                           ) -> list[EngineCoreOutput]:
        outputs: list[EngineCoreOutput] = []
        seen = {rid: i for i, rid in enumerate(runner_out.req_ids)}

        for rid, n_sched in sched_out.num_scheduled_tokens.items():
            req = self.requests.get(rid)
            if req is None or req.is_finished:
                continue
            i = seen.get(rid)
            sampled = (runner_out.sampled_token_ids[i]
                       if i is not None else [])
            # A decode window returns >1 sampled tokens per scheduled
            # token: each extra token's KV was computed in the window.
            req.num_computed_tokens += n_sched + max(0, len(sampled) - 1)
            if not sampled:
                continue  # mid-prefill chunk: nothing emitted
            new_tokens, finish = self._append_and_check_stop(req, sampled)
            if finish:
                self._free_request(req)
            lp = None
            if runner_out.logprobs is not None and i is not None:
                lp = runner_out.logprobs[i]
                if lp is not None:
                    lp = lp[:len(new_tokens)]
            outputs.append(
                EngineCoreOutput(
                    req_id=rid,
                    new_token_ids=new_tokens,
                    finished=req.is_finished,
                    finish_reason=req.get_finish_reason(),
                    stop_reason=req.stop_reason,
                    logprobs=lp,
                    num_cached_tokens=req.num_cached_tokens))
        return outputs

    def _append_and_check_stop(self, req: Request,
                               sampled: list[int]) -> tuple[list[int], bool]:
        """Append sampled tokens, truncating at any stop condition.
        Returns (emitted tokens, finished)."""
        params = req.sampling_params
        stop_ids = params.all_stop_token_ids
        emitted: list[int] = []
        for tok in sampled:
            emitted.append(tok)
            req.append_output_token_ids([tok])
            n_out = req.num_output_tokens
            if n_out < params.min_tokens:
                continue
            if not params.ignore_eos and req.eos_token_id is not None \
                    and tok == req.eos_token_id:
                req.status = RequestStatus.FINISHED_STOPPED
                return emitted, True
            if tok in stop_ids:
                req.status = RequestStatus.FINISHED_STOPPED
                req.stop_reason = tok
                if not params.include_stop_str_in_output:
                    emitted.pop()
                return emitted, True
            if n_out >= req.max_tokens or \
                    req.num_tokens >= self.config.max_model_len:
                req.status = RequestStatus.FINISHED_LENGTH_CAPPED
                return emitted, True
        return emitted, False

    # ------------------------------------------------------------------- state
    def has_unfinished_requests(self) -> bool:
        return bool(self.waiting or self.running)
