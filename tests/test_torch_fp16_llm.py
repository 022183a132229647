"""``LLM.generate`` in fp16 through the port against ``aphrodite_tpu.LLM``
in fp16 on the same weights (the JAX engine's tree through
``params_from_jax``; the fp16 kernels' plain versions are in
``test_torch_fp16.py`` and ``test_torch_fp16_decode.py``): a tiny Llama
with chunked prefill, decode windows and a shared prompt (the cascade),
on fp16, e4m3 and e5m2 caches, and a tiny BLOOM (ALiBi, the decode
kernel's plain version). Greedy tokens identical but, on the fp8 caches,
at ties below ``TIE`` (``test_torch_fp8_llm.py``'s rule, pinned in
``TIES``); chosen logprobs within ``LOGPROB_ATOL`` where the tokens agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.entrypoints.llm import LLM as JaxLLM
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.loader.weights import params_from_jax
from aphrodite_tpu_torch.ops import cascade_attention as cascade
from tests.test_torch_flexible import family_config, perturb
from tests.test_torch_fp8_llm import _margin, assert_tokens_match

TIE = 5e-2
# Where the tokens may part, at ties below TIE (test_torch_fp8_llm.py's
# rule): the counts observed, per case.
TIES = {"llama-fp16": 0, "llama-e4m3": 0, "llama-e5m2": 0, "bloom-fp16": 0}
# Chosen logprobs, the port against the JAX engine where the tokens agree:
# both engines run fp16 weights and activations with roundings at their
# own points (XLA's and PyTorch's CPU products). Measured: 7e-4 on the
# Llama, 2.9e-2 on BLOOM, whose weights redrawn at 3x fan-in scale give
# logits of tens, where one fp16 ulp is 8e-3 to 1.6e-2.
LOGPROB_ATOL = 5e-2
LLM_CASES = {"llama-fp16": ("llama", "auto"),
             "llama-e4m3": ("llama", "fp8_e4m3"),
             "llama-e5m2": ("llama", "fp8_e5m2"),
             "bloom-fp16": ("bloom", "auto")}
LLAMA = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=2, num_key_value_heads=1,
             intermediate_size=256, max_position_embeddings=512,
             rms_norm_eps=1e-5, tie_word_embeddings=False,
             architectures=["LlamaForCausalLM"])
MAX_TOKENS = 10


def _kwargs(model, kv, port=False):
    if model == "llama":  # 48-token chunks over a 5-page shared prompt
        from transformers import LlamaConfig
        kw = dict(hf_config=LlamaConfig(**LLAMA), block_size=16,
                  num_kv_blocks=128, max_num_seqs=4, max_num_batched_tokens=48,
                  max_model_len=256)
    else:
        kw = dict(hf_config=family_config("bloom"), block_size=16,
                  num_kv_blocks=64, max_num_seqs=4,
                  max_num_batched_tokens=16, max_model_len=128,
                  **({"decode_window": 8} if port else {}))
    return dict(kw, tokenizer="unused", dtype="float16", load_format="dummy",
                device="cpu", kv_cache_dtype=kv,
                **({} if port else {"async_scheduling": False}))


def _prompts(model):
    rng = np.random.RandomState(0)
    if model == "llama":
        shared = rng.randint(1, 250, size=80).tolist()   # 5 whole pages
        return [shared + rng.randint(1, 250, size=n).tolist()
                for n in (3, 17, 40)]
    return [rng.randint(1, 250, size=n).tolist() for n in (5, 40, 23)]


def _chosen(outs):
    return ([o.outputs[0].token_ids for o in outs],
            [[lp[t].logprob for t, lp in zip(o.outputs[0].token_ids,
                                              o.outputs[0].logprobs)]
             for o in outs])


@pytest.mark.parametrize("case", sorted(LLM_CASES))
def test_fp16_greedy_tokens_match_jax(case, monkeypatch):
    model, kv = LLM_CASES[case]
    jax_llm = JaxLLM("dummy", **_kwargs(model, kv))
    worker = jax_llm.engine.core.worker
    if model == "bloom":
        tree = perturb(worker.params, 11)
        worker.params = worker.runner.params = jax.tree.map(jnp.asarray,
                                                            tree)
    tree = worker.params
    prompts = _prompts(model)
    outs = jax_llm.generate(prompts, JaxParams(
        temperature=0.0, max_tokens=MAX_TOKENS, ignore_eos=True,
        logprobs=2))
    want, want_lp = _chosen(outs)
    margins = [[_margin(s) for s in o.outputs[0].logprobs] for o in outs]
    port = LLM("dummy", **_kwargs(model, kv, port=True))
    port.engine.core.worker.load_params(params_from_jax(tree))
    runner = port.engine.core.worker.runner
    assert runner.kv_cache.dtype == {
        "auto": torch.float16, "fp8_e4m3": torch.float8_e4m3fn,
        "fp8_e5m2": torch.float8_e5m2}[kv]
    passes = []
    spa = cascade.shared_prefix_attention
    monkeypatch.setattr(
        "aphrodite_tpu_torch.attention.backend.shared_prefix_attention",
        lambda *a: passes.append(a[4]) or spa(*a))
    got, got_lp = _chosen(port.generate(prompts, SamplingParams(
        temperature=0.0, max_tokens=MAX_TOKENS, ignore_eos=True,
        logprobs=1)))
    if model == "llama":
        assert passes and set(passes) == {80}  # the cascade branch ran
    assert len({t for x in want for t in x}) > 5  # the tokens vary
    gaps = [abs(a - b) for wt, gt, wl, gl in zip(want, got, want_lp, got_lp)
            for i, (a, b) in enumerate(zip(wl, gl)) if wt[:i + 1]
            == gt[:i + 1]]
    assert max(gaps) <= LOGPROB_ATOL, max(gaps)
    assert_tokens_match(port, prompts, want, margins, got, TIES[case])
