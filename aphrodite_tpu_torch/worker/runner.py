"""Model runner: turns a SchedulerOutput into device work, synchronously.

Counterpart of the JAX package's ``worker/runner.py`` for the serving main
path. Three kinds of step:

- ``_execute_step``: a prefill or mixed wave. The scheduled tokens are laid
  out back to back, K/V go into the paged cache, attention runs the ragged
  kernel, and each request whose scheduled tokens reach its end samples one
  token (``runner.py:277-349``).
- ``_execute_window``: when every scheduled request is a plain one-token
  decode, K decode sub-steps run with the paged cache frozen. Each
  sub-step's K/V go into per-layer tails, attention runs the window decode
  kernel, and the sampled token feeds the next sub-step on the device. At
  the end the tails are flushed into the pages (``runner.py:458-649``).
- ``_execute_multi_step``: the same decode windows for a model without
  window decode (Gemma family: ``supports_window_decode`` False). Each
  sub-step writes its K/V straight into the pages and attends with the
  decode kernel (``md.decode_mode``); no tails, no flush
  (``runner.py:352-456``).

Recurrent-state (Mamba-family) models have no paged KV cache: the model's
``{"conv", "ssm"}`` state buffers take its place, each request holds a
state slot (``_ssm_state_slots``), and the decode window is
``_execute_ssm_window``: K plain one-token forwards with no tails
(``runner.py:352-456``). The scheduler's page accounting still runs; the
model never reads a page.

PyTorch runs eagerly, so there are no shape buckets and no padding: every
token and request in a step is live.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from aphrodite_tpu_torch.attention.backend import kv_cache_shape
from aphrodite_tpu_torch.attention.metadata import (AttentionMetadata,
                                                    build_work_items)
from aphrodite_tpu_torch.config import EngineConfig
from aphrodite_tpu_torch.core.sched_output import (ModelRunnerOutput,
                                                   SchedulerOutput)
from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops.ragged_paged_attention import ragged_block_q
from aphrodite_tpu_torch.sample.sampler import greedy_sample
from aphrodite_tpu_torch.sampling_params import SamplingParams
from aphrodite_tpu_torch.utils import logger, next_power_of_2


@dataclass
class RequestState:
    req_id: str
    token_ids: list[int]
    prompt_len: int
    num_computed: int
    block_ids: list[int]
    sampling_params: Optional[SamplingParams]

    @property
    def num_tokens(self) -> int:
        return len(self.token_ids)

    @property
    def output_len(self) -> int:
        return len(self.token_ids) - self.prompt_len


class ModelRunner:

    def __init__(self, config: EngineConfig, model,
                 device: torch.device) -> None:
        self.config = config
        self.model = model
        self.device = device
        cc = config.cache_config
        self.block_size = cc.block_size
        self.max_pages_per_req = config.max_blocks_per_req
        self.requests: dict[str, RequestState] = {}
        self.is_ssm = getattr(model, "is_ssm", False)
        if self.is_ssm:
            # ``kv_cache`` holds the recurrent state, as in the JAX runner.
            self.num_state_slots = next_power_of_2(
                config.scheduler_config.max_num_seqs)
            self._free_slots = list(range(self.num_state_slots))
            self._slot_of: dict[str, int] = {}
            self.kv_cache = model.init_cache(self.num_state_slots)
            logger.info("SSM state: %d slots (%.2f GiB)",
                        self.num_state_slots, sum(
                            t.numel() * t.element_size()
                            for t in self.kv_cache.values()) / 2**30)
            return
        shape = kv_cache_shape(model.num_layers, cc.num_blocks, cc.block_size,
                               model.num_kv_heads, model.head_dim)
        self.kv_cache = torch.zeros(shape, dtype=model.dtype, device=device)
        logger.info("KV cache: %s %s (%.2f GiB)", shape, model.dtype,
                    self.kv_cache.numel() * self.kv_cache.element_size()
                    / 2**30)
        # Tokens per ragged work item, sized to the card's shared memory
        # (the JAX runner sizes its block_q from the geometry too,
        # ``runner.py:216-245``).
        self.block_q = ragged_block_q(
            model.num_heads // model.num_kv_heads, model.head_dim,
            cuda_build.smem_optin() if device.type == "cuda"
            else cuda_build.H100_SMEM_OPTIN)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    # --------------------------------------------------------- state updates
    def update_states(self, so: SchedulerOutput) -> None:
        for rid in so.finished_req_ids:
            self.requests.pop(rid, None)
            if self.is_ssm:
                slot = self._slot_of.pop(rid, None)
                if slot is not None:
                    self._free_slots.append(slot)
        cr = so.scheduled_cached_reqs
        for i, rid in enumerate(cr.req_ids):
            st = self.requests.get(rid)
            if cr.resumed_from_preemption[i] or st is None:
                if cr.all_token_ids[i] is None:
                    raise RuntimeError(f"request {rid}: no token list to "
                                       "resume from")
                self.requests[rid] = RequestState(
                    req_id=rid,
                    token_ids=list(cr.all_token_ids[i]),
                    prompt_len=(st.prompt_len if st else
                                len(cr.all_token_ids[i])),
                    num_computed=cr.num_computed_tokens[i],
                    block_ids=list(cr.new_block_ids[i]),
                    sampling_params=st.sampling_params if st else None)
            else:
                st.block_ids.extend(cr.new_block_ids[i])
                st.num_computed = cr.num_computed_tokens[i]
        for nr in so.scheduled_new_reqs:
            self.requests[nr.req_id] = RequestState(
                req_id=nr.req_id,
                token_ids=list(nr.prompt_token_ids),
                prompt_len=len(nr.prompt_token_ids),
                num_computed=nr.num_computed_tokens,
                block_ids=list(nr.block_ids),
                sampling_params=nr.sampling_params)

    @torch.inference_mode()
    def execute_model(self, so: SchedulerOutput) -> ModelRunnerOutput:
        self.update_states(so)
        if so.total_num_scheduled_tokens == 0:
            return ModelRunnerOutput(req_ids=[], sampled_token_ids=[])
        order = list(so.num_scheduled_tokens.keys())
        num_steps, budgets = self._window_eligibility(so, order)
        if num_steps > 1:
            if self.is_ssm:
                return self._execute_ssm_window(order, num_steps, budgets)
            if self.model.supports_window_decode:
                return self._execute_window(order, num_steps, budgets)
            return self._execute_multi_step(order, num_steps, budgets)
        return self._execute_step(so, order)

    def _block_tables(self, order: list[str]) -> np.ndarray:
        bt = np.zeros((len(order), self.max_pages_per_req), np.int32)
        for r, rid in enumerate(order):
            ids = self.requests[rid].block_ids
            bt[r, :len(ids)] = ids
        return bt

    # ------------------------------------------------------ single-step wave
    def _execute_step(self, so: SchedulerOutput,
                      order: list[str]) -> ModelRunnerOutput:
        R = len(order)
        T = so.total_num_scheduled_tokens
        bs = self.block_size
        input_ids = np.zeros((T,), np.int64)
        token_req = np.zeros((T,), np.int32)
        token_pos = np.zeros((T,), np.int32)
        slots = np.zeros((T,), np.int64)
        qsl = np.zeros((R + 1,), np.int32)
        seq_lens = np.zeros((R,), np.int32)
        samples_expected = []
        t = 0
        for r, rid in enumerate(order):
            st = self.requests[rid]
            n = so.num_scheduled_tokens[rid]
            start = st.num_computed
            pos = np.arange(start, start + n)
            input_ids[t:t + n] = st.token_ids[start:start + n]
            token_req[t:t + n] = r
            token_pos[t:t + n] = pos
            if not self.is_ssm:
                blocks = np.asarray(st.block_ids, np.int64)
                slots[t:t + n] = blocks[pos // bs] * bs + pos % bs
            t += n
            qsl[r + 1] = t
            seq_lens[r] = start + n
            samples_expected.append(start + n >= st.num_tokens)
        if self.is_ssm:
            qsl_d = self._dev(qsl)
            md = AttentionMetadata(
                token_req_idx=self._dev(token_req),
                token_pos=self._dev(token_pos), slot_mapping=None,
                seq_lens=self._dev(seq_lens), block_tables=None,
                query_start_loc=qsl_d, seg_starts=qsl_d[:-1],
                state_slots=self._dev(self._ssm_state_slots(order)))
        else:
            items = build_work_items(qsl[:-1], np.diff(qsl), seq_lens, R,
                                     self.block_q)
            md = AttentionMetadata(
                token_req_idx=self._dev(token_req),
                token_pos=self._dev(token_pos),
                slot_mapping=self._dev(slots),
                seq_lens=self._dev(seq_lens),
                block_tables=self._dev(self._block_tables(order)),
                block_q=self.block_q,
                **{k: self._dev(v) for k, v in items.items()})
        hidden = self.model(self._dev(input_ids), self.kv_cache, md)
        if not any(samples_expected):
            # Pure mid-prefill wave: nothing to sample.
            return ModelRunnerOutput(req_ids=order,
                                     sampled_token_ids=[[] for _ in order])
        last = self._dev(qsl[1:].astype(np.int64) - 1)
        tokens, logprob = greedy_sample(
            self.model.compute_logits(hidden[last]))
        tokens_h = tokens.cpu().numpy()
        lp_h = logprob.cpu().numpy()
        sampled, logprobs = [], []
        for r, rid in enumerate(order):
            if not samples_expected[r]:
                sampled.append([])
                logprobs.append(None)
                continue
            st = self.requests[rid]
            tok = int(tokens_h[r])
            st.token_ids.append(tok)
            sampled.append([tok])
            logprobs.append([{tok: float(lp_h[r])}]
                            if st.sampling_params.logprobs is not None
                            else None)
        return ModelRunnerOutput(
            req_ids=order, sampled_token_ids=sampled,
            logprobs=logprobs if any(x is not None for x in logprobs)
            else None)

    # ------------------------------------------------------ decode windows
    def _window_eligibility(self, so: SchedulerOutput, order: list[str]
                            ) -> tuple[int, Optional[list[int]]]:
        """(K, budgets): K > 1 when the whole batch is plain single-token
        decode. K is sized for the LARGEST remaining decode budget
        (max_tokens / max_model_len); requests with less budget hold their
        last token past their own limit (``runner.py:1866-1916``)."""
        K_cap = self.config.decode_window
        if K_cap <= 1:
            return 1, None
        max_len = self.config.scheduler_config.max_model_len
        budgets = []
        for rid in order:
            st = self.requests[rid]
            if so.num_scheduled_tokens[rid] != 1 \
                    or st.num_computed + 1 != st.num_tokens:
                return 1, None
            b = max_len - st.num_tokens
            mt = st.sampling_params.max_tokens
            if mt is not None:
                # This step's token counts toward max_tokens too.
                b = min(b, mt - st.output_len)
            if not st.sampling_params.ignore_eos:
                # EOS can cut generation anywhere: bound the window so
                # post-EOS waste stays moderate.
                K_cap = min(K_cap, 16)
            budgets.append(max(b, 1))
        K = min(K_cap, max(budgets))
        if K < 2:
            return 1, None
        return K, budgets

    def _execute_window(self, order: list[str], num_steps: int,
                        step_budgets: list[int]) -> ModelRunnerOutput:
        model, dev = self.model, self.device
        R, K, bs = len(order), num_steps, self.block_size
        cur = np.asarray([self.requests[rid].token_ids[-1] for rid in order],
                         np.int64)
        seq_lens0 = np.asarray([self.requests[rid].num_tokens
                                for rid in order], np.int32)
        counts = np.minimum(np.asarray(step_budgets, np.int32), K)
        block_tables = self._dev(self._block_tables(order))
        # The last token's KV is not in the pages yet: sub-step 0 computes
        # it into tail slot 0 (``runner.py:517``).
        paged_lens = self._dev(seq_lens0 - 1)
        budget = self._dev(counts)
        L, kvh, hd = model.num_layers, model.num_kv_heads, model.head_dim
        tail_k = torch.zeros((L, R, kvh, K, hd), dtype=self.kv_cache.dtype,
                             device=dev)
        tail_v = torch.zeros_like(tail_k)
        tok_buf = torch.empty((K, R), dtype=torch.int64, device=dev)
        lp_buf = torch.empty((K, R), dtype=torch.float32, device=dev)
        toks = self._dev(cur)
        arange_r = torch.arange(R, dtype=torch.int32, device=dev)
        for i in range(K):
            pos = paged_lens + i
            md = AttentionMetadata(
                token_req_idx=arange_r, token_pos=pos, slot_mapping=None,
                seq_lens=pos + 1,
                block_tables=block_tables, window_step=i,
                paged_lens=paged_lens)
            hidden = model.forward_window(toks, self.kv_cache, tail_k,
                                          tail_v, md)
            new_tok, lp = greedy_sample(model.compute_logits(hidden))
            # Rows past their budget hold their token (``runner.py:594``).
            toks = torch.where(i < budget, new_tok, toks)
            tok_buf[i] = toks
            lp_buf[i] = lp
        self._flush_tails(tail_k, tail_v, paged_lens, block_tables, budget)
        return self._window_output(order, counts, tok_buf, lp_buf)

    def _execute_multi_step(self, order: list[str], num_steps: int,
                            step_budgets: list[int]) -> ModelRunnerOutput:
        """K one-token forwards in decode mode (``runner.py:352-456``):
        sub-step i writes each live row's K/V at its position (the page
        ``block_tables[pos // page]``, inside the window's lookahead pages),
        attends positions 0..pos with the decode kernel and samples on the
        device; the token feeds sub-step i + 1. Rows past their budget get
        slot -1 (their K/V land in the null page), hold their token and
        keep their seq_len."""
        model, dev = self.model, self.device
        R, K, bs = len(order), num_steps, self.block_size
        cur = np.asarray([self.requests[rid].token_ids[-1] for rid in order],
                         np.int64)
        seq_lens0 = np.asarray([self.requests[rid].num_tokens
                                for rid in order], np.int32)
        counts = np.minimum(np.asarray(step_budgets, np.int32), K)
        budget = self._dev(counts)
        block_tables = self._dev(self._block_tables(order))
        bt_long = block_tables.long()
        arange_r = torch.arange(R, dtype=torch.int32, device=dev)
        seqlens = self._dev(seq_lens0)
        toks = self._dev(cur)
        tok_buf = torch.empty((K, R), dtype=torch.int64, device=dev)
        lp_buf = torch.empty((K, R), dtype=torch.float32, device=dev)
        for i in range(K):
            live = i < budget
            pos = seqlens - 1
            pages = torch.gather(bt_long, 1, (pos // bs).long()[:, None])[:, 0]
            slots = torch.where(live, pages * bs + (pos % bs).long(), -1)
            md = AttentionMetadata(
                token_req_idx=arange_r, token_pos=pos, slot_mapping=slots,
                seq_lens=seqlens, block_tables=block_tables,
                decode_mode=True)
            hidden = model(toks, self.kv_cache, md)
            new_tok, lp = greedy_sample(model.compute_logits(hidden))
            toks = torch.where(live, new_tok, toks)
            tok_buf[i] = toks
            lp_buf[i] = lp
            seqlens = seqlens + live.int()
        return self._window_output(order, counts, tok_buf, lp_buf)

    def _window_output(self, order: list[str], counts: np.ndarray,
                       tok_buf: torch.Tensor,
                       lp_buf: torch.Tensor) -> ModelRunnerOutput:
        """Row r's first counts[r] tokens of a window's [K, R] buffers."""
        tokens_h = tok_buf.cpu().numpy()
        lp_h = lp_buf.cpu().numpy()
        sampled, logprobs = [], []
        for r, rid in enumerate(order):
            st = self.requests[rid]
            toks_r = [int(x) for x in tokens_h[:counts[r], r]]
            st.token_ids.extend(toks_r)
            sampled.append(toks_r)
            logprobs.append([{t: float(lp_h[k, r])}
                             for k, t in enumerate(toks_r)]
                            if st.sampling_params.logprobs is not None
                            else None)
        return ModelRunnerOutput(
            req_ids=order, sampled_token_ids=sampled,
            logprobs=logprobs if any(x is not None for x in logprobs)
            else None)

    # ------------------------------------------------------------------- SSM
    def _ssm_state_slots(self, order: list[str]) -> np.ndarray:
        """A recurrent-state slot per request, kept until it finishes. With
        no slot free, take one from a request not scheduled now (a
        preempted request recomputes from position 0 when it resumes)
        (``runner.py:1848-1863``)."""
        state_slots = np.zeros((len(order),), np.int32)
        for r, rid in enumerate(order):
            slot = self._slot_of.get(rid)
            if slot is None:
                if not self._free_slots:
                    sched = set(order)
                    victim = next(r2 for r2 in self._slot_of
                                  if r2 not in sched)
                    self._free_slots.append(self._slot_of.pop(victim))
                slot = self._free_slots.pop()
                self._slot_of[rid] = slot
            state_slots[r] = slot
        return state_slots

    def _execute_ssm_window(self, order: list[str], num_steps: int,
                            step_budgets: list[int]) -> ModelRunnerOutput:
        """K one-token forwards of a recurrent-state model, each request its
        own segment; the sampled token feeds the next sub-step on the
        device. Rows past their budget hold their token and get
        seq_lens 0 and an invalid token, so they touch neither state
        (``runner.py:352-456``). No tails, no flush."""
        model, dev = self.model, self.device
        R, K = len(order), num_steps
        cur = np.asarray([self.requests[rid].token_ids[-1] for rid in order],
                         np.int64)
        seq_lens0 = np.asarray([self.requests[rid].num_tokens
                                for rid in order], np.int32)
        counts = np.minimum(np.asarray(step_budgets, np.int32), K)
        budget = self._dev(counts)
        state_slots = self._dev(self._ssm_state_slots(order))
        arange_r = torch.arange(R, dtype=torch.int32, device=dev)
        qsl = torch.arange(R + 1, dtype=torch.int32, device=dev)
        seqlens = self._dev(seq_lens0)
        toks = self._dev(cur)
        tok_buf = torch.empty((K, R), dtype=torch.int64, device=dev)
        lp_buf = torch.empty((K, R), dtype=torch.float32, device=dev)
        for i in range(K):
            live = i < budget
            md = AttentionMetadata(
                token_req_idx=arange_r, token_pos=seqlens - 1,
                slot_mapping=None, seq_lens=torch.where(live, seqlens, 0),
                block_tables=None, query_start_loc=qsl, seg_starts=arange_r,
                state_slots=state_slots, token_valid=live)
            hidden = model(toks, self.kv_cache, md)
            new_tok, lp = greedy_sample(model.compute_logits(hidden))
            toks = torch.where(live, new_tok, toks)
            tok_buf[i] = toks
            lp_buf[i] = lp
            seqlens = seqlens + live.int()
        return self._window_output(order, counts, tok_buf, lp_buf)

    def _flush_tails(self, tail_k: torch.Tensor, tail_v: torch.Tensor,
                     paged_lens: torch.Tensor, block_tables: torch.Tensor,
                     budget: torch.Tensor) -> None:
        """Land every valid tail slot (j < the row's budget) at its
        (page, offset) in every layer, before the next wave reads the
        pages (``runner.py:623-641``)."""
        bs = self.block_size
        K = tail_k.shape[3]
        j = torch.arange(K, device=self.device)
        abs_pos = paged_lens[:, None].long() + j[None, :]       # [R, K]
        valid = j[None, :] < budget[:, None]
        pages = torch.gather(block_tables.long(), 1, abs_pos // bs)
        pf, of = pages[valid], (abs_pos % bs)[valid]
        # tails [L, R, kvh, K, hd] -> [N, L, kvh, hd] rows for the valid
        # (request, slot) pairs; the advanced indices below put N first.
        self.kv_cache[:, pf, 0, :, of] = tail_k.permute(1, 3, 0, 2, 4)[valid]
        self.kv_cache[:, pf, 1, :, of] = tail_v.permute(1, 3, 0, 2, 4)[valid]
