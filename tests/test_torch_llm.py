"""The port's ``LLM.generate`` vs ``aphrodite_tpu.LLM`` on the same weights:
the JAX engine's parameter tree (``llm.engine.core.worker.params``) is
converted with ``params_from_jax`` and loaded into the port's worker.

Greedy token ids must be identical (fp32). Prompts of varied lengths with a
32-token batch budget force chunked prefill; 24 new tokens per request run
decode windows. Chosen-token logprobs agree to atol 1e-4."""
import numpy as np
import pytest

from aphrodite_tpu.entrypoints.llm import LLM as JaxLLM
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.loader.weights import params_from_jax

MAX_TOKENS = 24


def _kwargs():
    from transformers import Qwen2Config
    hf = Qwen2Config(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=8, num_key_value_heads=2,
                     intermediate_size=256, max_position_embeddings=512,
                     rms_norm_eps=1e-6, tie_word_embeddings=False,
                     architectures=["Qwen2ForCausalLM"])
    return dict(hf_config=hf, tokenizer="unused", dtype="float32",
                load_format="dummy", device="cpu", block_size=16,
                num_kv_blocks=128, max_num_seqs=4, max_num_batched_tokens=32,
                max_model_len=256)


@pytest.fixture(scope="module")
def engines():
    jax_llm = JaxLLM("dummy", **_kwargs())
    port = LLM("dummy", **_kwargs())
    port.engine.core.worker.load_params(
        params_from_jax(jax_llm.engine.core.worker.params))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 500, size=n).tolist()
               for n in (5, 40, 17, 70, 3, 33)]
    jax_outs = jax_llm.generate(prompts, JaxParams(
        temperature=0.0, max_tokens=MAX_TOKENS, ignore_eos=True,
        logprobs=0))
    return jax_outs, port, prompts


def _port_generate(port, prompts):
    return port.generate(prompts, SamplingParams(
        temperature=0.0, max_tokens=MAX_TOKENS, ignore_eos=True, logprobs=0))


def test_greedy_tokens_identical(engines):
    jax_outs, port, prompts = engines
    outs = _port_generate(port, prompts)
    for j, p in zip(jax_outs, outs):
        assert p.outputs[0].token_ids == j.outputs[0].token_ids
        assert len(p.outputs[0].token_ids) == MAX_TOKENS
        assert p.finished and p.outputs[0].finish_reason == "length"
    # The second pass hits the prefix cache and must not change a token.
    again = _port_generate(port, prompts)
    assert [o.outputs[0].token_ids for o in again] == \
        [o.outputs[0].token_ids for o in outs]
    assert any(o.num_cached_tokens > 0 for o in again)


def test_chosen_logprobs_match(engines):
    jax_outs, port, prompts = engines
    outs = _port_generate(port, prompts[:3])
    for j, p in zip(jax_outs, outs):
        jl = [next(iter(d.values())).logprob for d in j.outputs[0].logprobs]
        pl = [d[t].logprob for d, t in zip(p.outputs[0].logprobs,
                                           p.outputs[0].token_ids)]
        np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-4)


def test_reset_prefix_cache(engines):
    jax_outs, port, prompts = engines
    first = _port_generate(port, prompts[1:2])      # 40 tokens: 2 full pages
    hit = _port_generate(port, prompts[1:2])
    assert hit[0].num_cached_tokens > 0
    assert port.engine.reset_prefix_cache()
    cold = _port_generate(port, prompts[1:2])
    assert cold[0].num_cached_tokens == 0
    assert cold[0].outputs[0].token_ids == first[0].outputs[0].token_ids \
        == jax_outs[1].outputs[0].token_ids


def test_reset_prefix_cache_refused_while_running(engines):
    _, port, _ = engines
    port.engine.add_request("held", [1, 2, 3], SamplingParams(
        temperature=0.0, max_tokens=2, ignore_eos=True))
    port.engine.step()
    assert not port.engine.reset_prefix_cache()
    while port.engine.has_unfinished_requests():
        port.engine.step()
    assert port.engine.reset_prefix_cache()


@pytest.mark.parametrize("kw", [
    {"temperature": 0.8}, {"temperature": 0.0, "repetition_penalty": 1.2},
    {"temperature": 0.0, "n": 2}, {"temperature": 0.0, "logprobs": 3},
    {"temperature": 0.0, "stop": ["x"]},
    {"temperature": 0.0, "min_tokens": 2}])
def test_non_greedy_params_raise(engines, kw):
    _, port, _ = engines
    with pytest.raises(NotImplementedError):
        port.generate([[1, 2, 3]], SamplingParams(**kw))
