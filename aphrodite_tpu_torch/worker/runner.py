"""Model runner: turns a SchedulerOutput into device work, synchronously.

Counterpart of the JAX package's ``worker/runner.py`` for the serving main
path. Three kinds of step:

- ``_execute_step``: a prefill or mixed wave. The scheduled tokens are laid
  out back to back, K/V go into the paged cache, attention runs the ragged
  kernel, and each request whose scheduled tokens reach its end samples one
  token (``runner.py:277-349``); requests that ask for prompt logprobs get
  them for the wave's prompt positions (``runner.py:1104-1126``).
- ``_execute_window``: when every scheduled request is a plain one-token
  decode, K decode sub-steps run with the paged cache frozen. Each
  sub-step's K/V go into per-layer tails, attention runs the window decode
  kernel, and the sampled token feeds the next sub-step on the device. At
  the end the tails are flushed into the pages (``runner.py:458-649``).
  When every request holds the same leading pages (``_detect_shared_prefix``)
  the window attends them once a sub-step for the whole batch (cascade).
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

Sampling. Each wave and each window packs the batch's sampling parameters
once (``sample/metadata.py``, with room for a window's tokens in the
history) and every sub-step calls ``sample_tokens`` with ``step_offset =
i``, so row r's i-th token of a window draws from the counter out_len + i,
as the JAX runner's windows do. Where a stage reads the token history
(penalties, DRY, no-repeat-ngram) the history rides the sub-steps on the
device: each live row's token is written at its length, which then grows
(``runner.py:429-437, 590-601``). Nothing in a sub-step waits on the host.
An all-greedy batch without top-k logprobs runs ``greedy_sample`` alone and
uploads no metadata.

PyTorch runs eagerly, so there are no shape buckets and no padding: every
token and request in a step is live.

Images (a multimodal model: ``is_multimodal``). A request's images are
encoded at the first wave that schedules a token of theirs, through the
shared ``EncoderCache`` keyed by their content hash; each wave scatters
the image rows that its token ranges cover (``mm``: rows and their token
indices, ``runner.py:687-814``) and, for a model that sets
``needs_bidir_mm`` (Gemma-3), fills ``md.mm_bidir_spans`` with each
request's image spans (``runner.py:1054-1066``). A request drops its rows
once its prompt is computed. Decode sub-steps carry neither.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from aphrodite_tpu_torch.attention.backend import (as_bytes, cast_to,
                                                   kv_cache_shape)
from aphrodite_tpu_torch.attention.metadata import (AttentionMetadata,
                                                    build_work_items)
from aphrodite_tpu_torch.config import EngineConfig
from aphrodite_tpu_torch.core.sched_output import (ModelRunnerOutput,
                                                   SchedulerOutput)
from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops.cascade_attention import shared_prefix_plan
from aphrodite_tpu_torch.ops.decode_paged_attention import decode_plan
from aphrodite_tpu_torch.ops.ragged_paged_attention import (
    ragged_work_item_tokens)
from aphrodite_tpu_torch.ops.window_decode_attention import (tail_dtype,
                                                            window_plan)
from aphrodite_tpu_torch.sample.metadata import (SamplerFlags,
                                                 SamplingMetadata,
                                                 build_sampling_arrays)
from aphrodite_tpu_torch.sample.sampler import sample_tokens, topk
from aphrodite_tpu_torch.sampling_params import SamplingParams
from aphrodite_tpu_torch.utils import logger, next_power_of_2
from aphrodite_tpu_torch.worker.encoder_cache import EncoderCache


@dataclass
class RequestState:
    req_id: str
    token_ids: list[int]
    prompt_len: int
    num_computed: int
    block_ids: list[int]
    sampling_params: Optional[SamplingParams]
    # Prompt logprobs gathered so far ([None] for the first prompt token,
    # then {token: logprob} a position), emitted when the request samples.
    prompt_lp: Optional[list] = None
    # The prompt's images (``multimodal.MMInputs``) and their encoded rows
    # [n image tokens, hidden] on the device, made at first use and dropped
    # once the prompt is computed.
    mm: Optional[object] = None
    mm_embeds: Optional[torch.Tensor] = None

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
        # Unseeded requests draw from base_seed + r * 7919 (r: the row).
        self._base_seed = config.model_config.seed
        self.is_ssm = getattr(model, "is_ssm", False)
        # Encoded images shared across requests (``runner.py:164-166``).
        self.encoder_cache = EncoderCache()
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
        # The model's dtype, or fp8 (``runner.py:92-96``).
        kv_dtype = cc.torch_dtype(config.model_config.dtype)
        self.kv_cache = torch.zeros(shape, dtype=kv_dtype, device=device)
        # The window tails: bf16 beside an e5m2 cache, else the cache's
        # dtype (``runner.py:519-520``).
        self.tail_dtype = tail_dtype(kv_dtype)
        logger.info("KV cache: %s %s (%.2f GiB)", shape, kv_dtype,
                    self.kv_cache.numel() * self.kv_cache.element_size()
                    / 2**30)
        # Tokens per ragged work item, sized for the kernel instance that
        # the model's dtype and the cache's run and to the card's shared
        # memory (the JAX runner sizes its block_q from the geometry too,
        # ``runner.py:216-245``).
        self.block_q = ragged_work_item_tokens(
            model.dtype, model.num_heads // model.num_kv_heads,
            model.head_dim,
            cuda_build.smem_optin() if device.type == "cuda"
            else cuda_build.H100_SMEM_OPTIN, kv_dtype)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _sampling(self, order: list[str], num_steps: int = 1
                  ) -> tuple[Optional[SamplingMetadata], SamplerFlags, int]:
        """(metadata on the device, flags, max_lp) for the batch ``order``
        and ``num_steps`` draws (``runner.py:901-916``; the history has
        room for a decode window): max_lp is the next power of two of the
        largest top-k logprobs asked. The metadata stays on the host (None)
        where ``sample_tokens`` runs the argmax alone."""
        reqs, max_logprobs = [], 0
        for rid in order:
            st = self.requests[rid]
            p = st.sampling_params
            reqs.append((p, st.token_ids, st.prompt_len, st.output_len))
            if p.logprobs:
                max_logprobs = max(max_logprobs, p.logprobs)
        arrays, flags = build_sampling_arrays(
            reqs, self.model.vocab_size, len(order),
            base_seed=self._base_seed,
            extra_len=self.config.decode_window + 1, num_steps=num_steps)
        max_lp = next_power_of_2(max_logprobs) if max_logprobs else 0
        md = None
        if not flags.all_greedy or max_lp:
            md = SamplingMetadata.from_arrays(arrays, self.device)
        return md, flags, max_lp

    def _logprob_dicts(self, st: RequestState, toks: list[int], lp_h,
                       tv_h, ti_h) -> Optional[list[dict[int, float]]]:
        """{token: logprob} a sampled token, with the top ``logprobs``
        entries where asked (``runner.py:1300-1313``); None where the
        request asked for no logprobs. ``lp_h`` [n], ``tv_h``/``ti_h``
        [n, max_lp] or None, row k for toks[k]."""
        p = st.sampling_params
        if p.logprobs is None:
            return None
        out = []
        for k, tok in enumerate(toks):
            d = {tok: float(lp_h[k])}
            if p.logprobs and tv_h is not None:
                for v, i in zip(tv_h[k][:p.logprobs], ti_h[k][:p.logprobs]):
                    d[int(i)] = float(v)
            out.append(d)
        return out

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
                    sampling_params=st.sampling_params if st else None,
                    mm=st.mm if st else None)
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
                sampling_params=nr.sampling_params, mm=nr.mm_inputs)

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
                mm_bidir_spans=self._span_rows(order),
                **{k: self._dev(v) for k, v in items.items()})
        mm = self._build_mm_arg(so, order, qsl)
        hidden = self.model(self._dev(input_ids), self.kv_cache, md,
                            **({} if mm is None else {"mm": mm}))
        if mm is not None:
            # Image rows are read only by prefill (``runner.py:1157-1167``).
            for rid in order:
                st = self.requests[rid]
                if st.num_computed + so.num_scheduled_tokens[rid] \
                        >= st.prompt_len:
                    st.mm_embeds = None
        self._prompt_logprobs(so, order, qsl, hidden)
        if not any(samples_expected):
            # Pure mid-prefill wave: nothing to sample.
            return ModelRunnerOutput(req_ids=order,
                                     sampled_token_ids=[[] for _ in order])
        smd, flags, max_lp = self._sampling(order)
        last = self._dev(qsl[1:].astype(np.int64) - 1)
        out = sample_tokens(self.model.compute_logits(hidden[last]), smd,
                            flags, max_lp)
        tokens_h = out["tokens"].cpu().numpy()
        lp_h = out["logprob"].cpu().numpy()
        tv_h = ti_h = None
        if max_lp:
            tv_h = out["topk_values"].cpu().numpy()
            ti_h = out["topk_indices"].cpu().numpy()
        sampled, logprobs, prompt_lps = [], [], {}
        for r, rid in enumerate(order):
            if not samples_expected[r]:
                sampled.append([])
                logprobs.append(None)
                continue
            st = self.requests[rid]
            tok = int(tokens_h[r])
            st.token_ids.append(tok)
            sampled.append([tok])
            logprobs.append(self._logprob_dicts(
                st, [tok], lp_h[r:r + 1],
                None if tv_h is None else tv_h[r:r + 1],
                None if ti_h is None else ti_h[r:r + 1]))
            if st.prompt_lp is not None:
                prompt_lps[rid] = st.prompt_lp
        return ModelRunnerOutput(
            req_ids=order, sampled_token_ids=sampled,
            logprobs=logprobs if any(x is not None for x in logprobs)
            else None, prompt_logprobs=prompt_lps or None)

    # ------------------------------------------------------------ images
    def _mm_embeds(self, st: RequestState) -> torch.Tensor:
        """The request's image rows: its own, else the encoder cache's
        entry for its images, else encoded now and cached
        (``runner.py:687-740``)."""
        if st.mm_embeds is None:
            key = st.mm.content_hash()
            st.mm_embeds = self.encoder_cache.get(key)
            if st.mm_embeds is None:
                st.mm_embeds = self.model.encode_images(
                    torch.from_numpy(st.mm.pixel_values).to(self.device))
                self.encoder_cache.put(key, st.mm_embeds)
        return st.mm_embeds

    def _build_mm_arg(self, so: SchedulerOutput, order: list[str],
                      qsl: np.ndarray
                      ) -> Optional[tuple[torch.Tensor, torch.Tensor]]:
        """(image rows, their flat token indices) that this wave's token
        ranges cover, or None (``runner.py:742-814``)."""
        pieces, idx_parts = [], []
        for r, rid in enumerate(order):
            st = self.requests[rid]
            if st.mm is None or st.num_computed >= st.prompt_len:
                continue
            start, n = st.num_computed, so.num_scheduled_tokens[rid]
            base = 0
            for off, ln in st.mm.spans:
                lo, hi = max(off, start), min(off + ln, start + n)
                if lo < hi:
                    emb = self._mm_embeds(st)
                    pieces.append(emb[base + lo - off:base + hi - off])
                    t0 = int(qsl[r]) + lo - start
                    idx_parts.append(np.arange(t0, t0 + hi - lo))
                base += ln
        if not pieces:
            return None
        return (torch.cat(pieces),
                self._dev(np.concatenate(idx_parts).astype(np.int64)))

    def _span_rows(self, order: list[str]) -> Optional[torch.Tensor]:
        """[R, M, 2] int32 image spans (lo, hi) of each request, -1
        padding, M the next power of two (at least 2) of the most images a
        request has; None where the model attends causally or no request
        has an image (``runner.py:1054-1066``)."""
        if not getattr(self.model, "needs_bidir_mm", False):
            return None
        spans = [self.requests[rid].mm.spans
                 if self.requests[rid].mm is not None else [] for rid in order]
        most = max((len(s) for s in spans), default=0)
        if not most:
            return None
        arr = np.full((len(order), next_power_of_2(max(most, 2)), 2), -1,
                      np.int32)
        for r, sp in enumerate(spans):
            for j, (off, ln) in enumerate(sp):
                arr[r, j] = (off, off + ln)
        return self._dev(arr)

    def _prompt_logprobs(self, so: SchedulerOutput, order: list[str],
                         qsl: np.ndarray, hidden: torch.Tensor) -> None:
        """Append the wave's prompt logprobs to each request that asks for
        them: at scheduled token j (position pos), the log-softmax of its
        logits at the next prompt token, and the top ``prompt_logprobs``
        entries (``runner.py:329-340, 1104-1126, 1185-1205``). The JAX
        runner takes the logits of every scheduled token; here only those
        of the asking requests' prompt positions, with the same values."""
        rows, targets, where, plp_k = [], [], [], 0
        for r, rid in enumerate(order):
            st = self.requests[rid]
            k_req = st.sampling_params.prompt_logprobs
            plp_k = max(plp_k, k_req or 0)
            if k_req is None or st.num_computed >= st.prompt_len:
                continue
            if st.prompt_lp is None:
                st.prompt_lp = [None]  # the first prompt token
            for j in range(so.num_scheduled_tokens[rid]):
                pos = st.num_computed + j + 1
                if pos >= st.prompt_len:
                    break
                rows.append(int(qsl[r]) + j)
                targets.append(st.token_ids[pos])
                where.append(r)
        if not rows:
            return
        plp_k = next_power_of_2(plp_k) if plp_k else 0
        lsm = torch.log_softmax(self.model.compute_logits(
            hidden[self._dev(np.asarray(rows, np.int64))]).float(), dim=-1)
        chosen = torch.gather(lsm, 1, self._dev(np.asarray(
            targets, np.int64))[:, None])[:, 0].cpu().numpy()
        tv = ti = None
        if plp_k:
            tv, ti = (t.cpu().numpy() for t in topk(lsm, plp_k))
        for n, (r, tok) in enumerate(zip(where, targets)):
            st = self.requests[order[r]]
            d = {int(tok): float(chosen[n])}
            k_req = st.sampling_params.prompt_logprobs
            if k_req and tv is not None:
                for v, i in zip(tv[n][:k_req], ti[n][:k_req]):
                    d[int(i)] = float(v)
            st.prompt_lp.append(d)

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
        shared = self._detect_shared_prefix(order, int(seq_lens0.min()) - 1)
        shared_pages, shared_len = None, None
        if shared is not None:
            shared_pages = self._dev(np.asarray(shared[0], np.int32))
            shared_len = shared[1]
        # The last token's KV is not in the pages yet: sub-step 0 computes
        # it into tail slot 0 (``runner.py:517``).
        paged_lens = self._dev(seq_lens0 - 1)
        budget = self._dev(counts)
        L, kvh, hd = model.num_layers, model.num_kv_heads, model.head_dim
        plan = shared_plan = None
        if dev.type == "cuda":
            # One launch plan for every layer and sub-step, bounded by the
            # longest paged length and the last sub-step. The splits skip
            # the shared prefix only where the layers take the cascade: with
            # no sliding window (``backend.window_attention``).
            sw = getattr(model, "sliding_window", None)
            plan = window_plan(
                model.dtype, R, model.num_heads, kvh, hd, dev,
                int(seq_lens0.max()) - 1, K - 1,
                shared_len=shared_len if shared_len and sw is None else 0,
                sliding_window=sw, kv_dtype=self.kv_cache.dtype)
            if shared_len:
                shared_plan = shared_prefix_plan(
                    model.dtype, R, model.num_heads, kvh, hd, shared_len,
                    dev, self.kv_cache.dtype)
        tail_k = torch.zeros((L, R, kvh, K, hd), dtype=self.tail_dtype,
                             device=dev)
        tail_v = torch.zeros_like(tail_k)
        toks = self._dev(cur)
        arange_r = torch.arange(R, dtype=torch.int32, device=dev)
        sampler = _WindowSampler(self, order, K)
        for i in range(K):
            pos = paged_lens + i
            md = AttentionMetadata(
                token_req_idx=arange_r, token_pos=pos, slot_mapping=None,
                seq_lens=pos + 1,
                block_tables=block_tables, window_step=i,
                paged_lens=paged_lens, window_plan=plan,
                shared_pages=shared_pages, shared_len=shared_len,
                shared_plan=shared_plan)
            hidden = model.forward_window(toks, self.kv_cache, tail_k,
                                          tail_v, md)
            # Rows past their budget hold their token (``runner.py:594``).
            toks = sampler.step(i, model.compute_logits(hidden), toks,
                                i < budget)
        self._flush_tails(tail_k, tail_v, paged_lens, block_tables, budget)
        return self._window_output(order, counts, sampler)

    def _detect_shared_prefix(self, order: list[str], min_plen: int
                              ) -> Optional[tuple[list[int], int]]:
        """(shared page ids, shared token count) when every request of the
        batch holds the same leading block ids (prefix caching dedups them
        physically), at most ``min_plen // block_size`` of them and at least
        4; else None (``runner.py:1407-1426``; the JAX runner pads the ids
        to a power of two for its jit layouts, the port passes them as
        they are)."""
        if len(order) < 2:
            return None
        tables = [self.requests[rid].block_ids for rid in order]
        first = tables[0]
        k = min(min(len(t) for t in tables), min_plen // self.block_size)
        n = 0
        while n < k and all(t[n] == first[n] for t in tables):
            n += 1
        if n < 4:  # a short shared prefix is not worth the extra pass
            return None
        return list(first[:n]), n * self.block_size

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
        sampler = _WindowSampler(self, order, K)
        plan = None
        if dev.type == "cuda":
            # One launch plan for every layer and sub-step, bounded by the
            # longest context of the last sub-step (a layer's sliding window
            # only shortens its range).
            plan = decode_plan(
                model.dtype, R, model.num_heads, model.num_kv_heads,
                model.head_dim, dev, int(seq_lens0.max()) + K - 1,
                kv_dtype=self.kv_cache.dtype)
        for i in range(K):
            live = i < budget
            pos = seqlens - 1
            pages = torch.gather(bt_long, 1, (pos // bs).long()[:, None])[:, 0]
            slots = torch.where(live, pages * bs + (pos % bs).long(), -1)
            md = AttentionMetadata(
                token_req_idx=arange_r, token_pos=pos, slot_mapping=slots,
                seq_lens=seqlens, block_tables=block_tables,
                decode_mode=True, decode_plan=plan)
            hidden = model(toks, self.kv_cache, md)
            toks = sampler.step(i, model.compute_logits(hidden), toks, live)
            seqlens = seqlens + live.int()
        return self._window_output(order, counts, sampler)

    def _window_output(self, order: list[str], counts: np.ndarray,
                       sampler: "_WindowSampler") -> ModelRunnerOutput:
        """Row r's first counts[r] tokens of a window's [K, R] buffers."""
        tokens_h = sampler.tok_buf.cpu().numpy()
        lp_h = sampler.lp_buf.cpu().numpy()
        tv_h = ti_h = None
        if sampler.max_lp:
            tv_h = sampler.tv_buf.cpu().numpy()
            ti_h = sampler.ti_buf.cpu().numpy()
        sampled, logprobs = [], []
        for r, rid in enumerate(order):
            st = self.requests[rid]
            n = int(counts[r])
            toks_r = [int(x) for x in tokens_h[:n, r]]
            st.token_ids.extend(toks_r)
            sampled.append(toks_r)
            logprobs.append(self._logprob_dicts(
                st, toks_r, lp_h[:n, r],
                None if tv_h is None else tv_h[:n, r],
                None if ti_h is None else ti_h[:n, r]))
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
        sampler = _WindowSampler(self, order, K)
        for i in range(K):
            live = i < budget
            md = AttentionMetadata(
                token_req_idx=arange_r, token_pos=seqlens - 1,
                slot_mapping=None, seq_lens=torch.where(live, seqlens, 0),
                block_tables=None, query_start_loc=qsl, seg_starts=arange_r,
                state_slots=state_slots, token_valid=live)
            hidden = model(toks, self.kv_cache, md)
            toks = sampler.step(i, model.compute_logits(hidden), toks, live)
            seqlens = seqlens + live.int()
        return self._window_output(order, counts, sampler)

    def _flush_tails(self, tail_k: torch.Tensor, tail_v: torch.Tensor,
                     paged_lens: torch.Tensor, block_tables: torch.Tensor,
                     budget: torch.Tensor) -> None:
        """Land every valid tail slot (j < the row's budget) at its
        (page, offset) in every layer, before the next wave reads the
        pages (``runner.py:623-641``), cast to the cache's dtype as the
        reference casts (bf16 tails into an e5m2 cache)."""
        bs = self.block_size
        K = tail_k.shape[3]
        j = torch.arange(K, device=self.device)
        abs_pos = paged_lens[:, None].long() + j[None, :]       # [R, K]
        valid = j[None, :] < budget[:, None]
        pages = torch.gather(block_tables.long(), 1, abs_pos // bs)
        pf, of = pages[valid], (abs_pos % bs)[valid]
        # tails [L, R, kvh, K, hd] -> [N, L, kvh, hd] rows for the valid
        # (request, slot) pairs; the advanced indices below put N first.
        cache = as_bytes(self.kv_cache)
        for i, tail in enumerate((tail_k, tail_v)):
            rows = tail.permute(1, 3, 0, 2, 4)[valid]
            cache[:, pf, i, :, of] = as_bytes(cast_to(rows,
                                                      self.kv_cache.dtype))


class _WindowSampler:
    """A decode window's sampling: the batch's metadata, packed once, and
    [K, R] buffers of each sub-step's tokens, logprobs and top-k logprobs
    (``runner.py:383-395``). Where a stage reads the token history, the
    history rides the sub-steps on the device."""

    def __init__(self, runner: ModelRunner, order: list[str], K: int):
        dev = runner.device
        R = len(order)
        self.md, self.flags, self.max_lp = runner._sampling(order, K)
        self.track = self.flags.track_tokens
        if self.track:
            # The window's own copy: a row's token is written at its
            # length, which then grows (``runner.py:429-437``).
            self.hist, self.hlen = self.md.token_seq, self.md.total_len
        self.tok_buf = torch.empty((K, R), dtype=torch.int64, device=dev)
        self.lp_buf = torch.empty((K, R), dtype=torch.float32, device=dev)
        if self.max_lp:
            self.tv_buf = torch.empty((K, R, self.max_lp),
                                      dtype=torch.float32, device=dev)
            self.ti_buf = torch.empty((K, R, self.max_lp), dtype=torch.int64,
                                      device=dev)

    def step(self, i: int, logits: torch.Tensor, toks: torch.Tensor,
             live: torch.Tensor) -> torch.Tensor:
        """Sample sub-step ``i`` (counter out_len + i); rows that are not
        ``live`` (past their budget) hold ``toks``. Returns the tokens that
        feed sub-step i + 1."""
        md = (replace(self.md, token_seq=self.hist, total_len=self.hlen)
              if self.track else self.md)
        out = sample_tokens(logits, md, self.flags, self.max_lp,
                            step_offset=i, donate_logits=True)
        toks = torch.where(live, out["tokens"], toks)
        if self.track:
            # A held row writes past its length, where no stage reads
            # (every stage stops at total_len); the buffer has room for a
            # window's tokens.
            self.hist.scatter_(1, self.hlen[:, None].long(),
                               toks[:, None].to(self.hist.dtype))
            self.hlen = self.hlen + live.to(self.hlen.dtype)
        self.tok_buf[i] = toks
        self.lp_buf[i] = out["logprob"]
        if self.max_lp:
            self.tv_buf[i] = out["topk_values"]
            self.ti_buf[i] = out["topk_indices"]
        return toks
