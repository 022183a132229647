"""The port's ``LLM.generate`` vs ``aphrodite_tpu.LLM`` on the same weights
for each ``FlexibleDecoder`` family of ``tests/test_torch_flexible.py``
(BLOOM, MPT with clip_qkv, Falcon-rw / 7b / new architecture, Baichuan
with ALiBi and with rope): the JAX engine's dummy tree, redrawn by
``test_torch_flexible.perturb``, is loaded into both engines, the port's
through ``params_from_jax``.

Greedy token ids must be identical (fp32). A 16-token batch budget cuts the
prompts into chunks, so mixed waves carry chunks whose queries sit past the
keys that earlier chunks cached (ALiBi's distances are absolute); decode
windows of 8 run the runner's non-window multi-step path
(``_execute_multi_step``: these models have no window decode), with ragged
``max_tokens`` freezing rows inside the windows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aphrodite_tpu.entrypoints.llm import LLM as JaxLLM
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.loader.weights import params_from_jax
from aphrodite_tpu_torch.ops import decode_paged_attention as decode_mod
from aphrodite_tpu_torch.ops import ragged_paged_attention as ragged_mod

from tests.test_torch_flexible import (ALIBI, FAMILIES, LOGITS_ONLY,
                                       family_config, perturb)

MAX_TOKENS = (12, 5, 20)
PROMPT_LENS = (5, 40, 23)


def _kwargs(name, port=False):
    return dict(hf_config=family_config(name), tokenizer="unused",
                dtype="float32", load_format="dummy", device="cpu",
                block_size=16, num_kv_blocks=64, max_num_seqs=4,
                max_num_batched_tokens=16, max_model_len=64,
                **({} if port else {"async_scheduling": False}))


@pytest.mark.parametrize("name", sorted(set(FAMILIES) - set(LOGITS_ONLY)))
def test_greedy_tokens_identical(name, monkeypatch):
    jax_llm = JaxLLM("dummy", **_kwargs(name))
    worker = jax_llm.engine.core.worker
    tree = perturb(worker.params, 11)
    worker.params = worker.runner.params = jax.tree.map(jnp.asarray, tree)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 250, size=n).tolist() for n in PROMPT_LENS]
    jax_tokens = [o.outputs[0].token_ids for o in jax_llm.generate(
        prompts, [JaxParams(temperature=0.0, max_tokens=n, ignore_eos=True)
                  for n in MAX_TOKENS])]

    port = LLM("dummy", decode_window=8, **_kwargs(name, port=True))
    port.engine.core.worker.load_params(params_from_jax(tree))
    runner = port.engine.core.worker.runner
    windows, slopes = [], {"ragged": 0, "decode": 0}
    multi_step = runner._execute_multi_step

    def counted(*a, **kw):
        windows.append(a[1])
        return multi_step(*a, **kw)

    def spy(kind, fn):
        def wrapped(*a, **kw):
            slopes[kind] += kw.get("alibi") is not None
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(runner, "_execute_multi_step", counted)
    monkeypatch.setattr(ragged_mod, "ref_ragged_paged_attention",
                        spy("ragged", ragged_mod.ref_ragged_paged_attention))
    monkeypatch.setattr(decode_mod, "ref_decode_paged_attention",
                        spy("decode", decode_mod.ref_decode_paged_attention))
    outs = port.generate(prompts, [
        SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True)
        for n in MAX_TOKENS])
    assert [o.outputs[0].token_ids for o in outs] == jax_tokens
    assert [len(t) for t in jax_tokens] == list(MAX_TOKENS)
    # Decode went through multi-step windows of 8.
    assert max(windows) == 8
    # Not a fixed point of the weights: the tokens vary.
    assert len({t for toks in jax_tokens for t in toks}) > 10
    # Both attention paths took the model's slopes exactly for ALiBi.
    if name in ALIBI:
        assert slopes["ragged"] > 0 and slopes["decode"] > 0
    else:
        assert slopes == {"ragged": 0, "decode": 0}
