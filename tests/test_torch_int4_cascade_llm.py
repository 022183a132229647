"""The port's ``LLM.generate`` vs ``aphrodite_tpu.LLM`` on the same weights,
greedy token ids identical in fp32, for the two paths of the int4 and
cascade slice:

(a) gptq W4A16 realized to native int4 (``realize_int4_leaves``) on both
    engines: a one-layer Llama at K = 2048 (every projection packs under
    gptq's group of 128), 100 prompts against ``max_num_seqs=72``, so that
    decode windows run at M = 72 (the int4 kernel's band, 64 < M <= 256)
    and, for the last 28 requests, at M <= 64 (the grouped product);
(b) a 100-token prefix shared by three requests on 16-token pages (the
    shape of ``tests/e2e/test_cascade_e2e.py:28-33``): prefix caching
    dedups its 6 pages, the window runs the cascade branch, and the tokens
    equal both the JAX engine's and the port's own with
    ``_detect_shared_prefix`` patched to None."""
import numpy as np
import pytest

from aphrodite_tpu.entrypoints.llm import LLM as JaxLLM
from aphrodite_tpu.loader.weights import \
    realize_int4_leaves as jax_realize_int4_leaves
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.loader.weights import (params_from_jax,
                                                realize_int4_leaves)
from aphrodite_tpu_torch.ops import cascade_attention


def _llama(H, inter, heads, **kw):
    from transformers import LlamaConfig
    return dict(hf_config=LlamaConfig(
        vocab_size=256, hidden_size=H, num_hidden_layers=1,
        num_attention_heads=heads, num_key_value_heads=2,
        intermediate_size=inter, max_position_embeddings=512,
        rms_norm_eps=1e-5, tie_word_embeddings=False,
        architectures=["LlamaForCausalLM"]), tokenizer="unused",
        dtype="float32", load_format="dummy", device="cpu", **kw)


INT4_KW = _llama(2048, 2048, 16, quantization="gptq", block_size=16,
                 num_kv_blocks=512, max_num_seqs=72,
                 max_num_batched_tokens=2048, max_model_len=128)


@pytest.fixture(scope="module")
def int4_case():
    # The JAX dispatch's 64 < M <= 256 band takes its Pallas kernel only
    # in interpret mode; without it, its XLA dequantize path, which
    # computes the same function.
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APHRODITE_PALLAS_INTERPRET", "0")
        jax_llm = JaxLLM("dummy", **INT4_KW)
        worker = jax_llm.engine.core.worker
        tree = jax_realize_int4_leaves(worker.params)
        worker.params = worker.runner.params = tree
        rng = np.random.RandomState(0)
        prompts = [rng.randint(1, 250, size=3 + i % 17).tolist()
                   for i in range(100)]
        params = [JaxParams(temperature=0.0, max_tokens=4 + i % 5,
                            ignore_eos=True) for i in range(100)]
        jax_tokens = [o.outputs[0].token_ids
                      for o in jax_llm.generate(prompts, params)]
    return tree, prompts, jax_tokens


def test_int4_greedy_tokens_identical(int4_case):
    tree, prompts, jax_tokens = int4_case
    assert any(k.endswith(".qweight4") for k in params_from_jax(tree))
    port = LLM("dummy", **INT4_KW)
    model = port.engine.core.worker.model
    realize_int4_leaves(model)
    port.engine.core.worker.load_params(params_from_jax(tree))
    for name in ("w_qkv", "wo", "w_gate_up", "w_down"):
        assert "qweight4" in getattr(model.layers[0], name).leaves()
    ms = []
    runner = port.engine.core.worker.runner
    window = runner._execute_window
    runner._execute_window = lambda order, *a: ms.append(len(order)) or \
        window(order, *a)
    got = port.generate(prompts, [
        SamplingParams(temperature=0.0, max_tokens=4 + i % 5,
                       ignore_eos=True) for i in range(100)])
    assert [o.outputs[0].token_ids for o in got] == jax_tokens
    assert max(ms) > 64 and min(ms) <= 64, ms


CASCADE_KW = _llama(64, 128, 4, block_size=16, num_kv_blocks=256,
                    max_num_batched_tokens=512, max_num_seqs=4,
                    max_model_len=256)


def _prompts():
    rng = np.random.RandomState(0)
    shared = rng.randint(10, 200, size=100).tolist()  # 6 whole pages
    return [shared + rng.randint(10, 200, size=5 + i).tolist()
            for i in range(3)]


@pytest.fixture(scope="module")
def cascade_case():
    jax_llm = JaxLLM("dummy", **CASCADE_KW)
    out = jax_llm.generate(_prompts(), JaxParams(
        temperature=0.0, max_tokens=12, ignore_eos=True))
    return (jax_llm.engine.core.worker.params,
            [o.outputs[0].token_ids for o in out])


def _port_tokens(tree, detect: bool, monkeypatch):
    port = LLM("dummy", **CASCADE_KW)
    port.engine.core.worker.load_params(params_from_jax(tree))
    runner = port.engine.core.worker.runner
    found, passes = [], []
    detect_fn = runner._detect_shared_prefix
    monkeypatch.setattr(runner, "_detect_shared_prefix",
                        lambda *a: found.append(detect_fn(*a) if detect
                                                else None) or found[-1])
    spa = cascade_attention.shared_prefix_attention
    monkeypatch.setattr(
        "aphrodite_tpu_torch.attention.backend.shared_prefix_attention",
        lambda *a: passes.append(a[4]) or spa(*a))
    out = port.generate(_prompts(), SamplingParams(
        temperature=0.0, max_tokens=12, ignore_eos=True))
    return [o.outputs[0].token_ids for o in out], found, passes


def test_cascade_greedy_tokens_identical(cascade_case, monkeypatch):
    tree, jax_tokens = cascade_case
    with_c, found, passes = _port_tokens(tree, True, monkeypatch)
    assert found and found[0] is not None
    pages, S = found[0]
    assert len(pages) == 6 and S == 96
    assert passes and set(passes) == {96}  # the cascade branch ran
    without, found, passes = _port_tokens(tree, False, monkeypatch)
    assert found and not passes
    assert with_c == without == jax_tokens
