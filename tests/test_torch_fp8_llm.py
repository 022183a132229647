"""The port's ``LLM.generate`` with fp8 / int8 quantization and an fp8 KV
cache vs ``aphrodite_tpu.LLM`` with the same ``quantization=`` and
``kv_cache_dtype=`` on the same weights (the JAX engine's quantized tree
through ``params_from_jax``), fp32, greedy. Cases, as ``chip_smoke.py``
phase 17: (fp8, fp8_e4m3), (fp8_w8a8, fp8_e5m2), (int8, auto).

Tokens must be identical, with one stated exception. These formats round
activations (W8A8) or K/V (fp8 cache) to 8 bits, so where two runs' fp32
products differ in their last bit (another summation order, or the same
package at another batch composition: chunked prefill splits a prompt
where the batch puts it) a value can land on the other side of a rounding
boundary, and moves by an eighth of itself (e4m3) or a quarter (e5m2). A
greedy pick between two logprobs closer than ``TIE`` = 5e-2 is therefore
not decided by the format (the JAX engine's own logprobs for one request
move by a few 1e-2 between the request run alone and in this batch, under
W8A8 on an e5m2 cache, and a margin is a difference of two); at
such a step (the reference's own top-2 margin, from its logprobs) a
request may take the other token; the port then goes on from the
reference's token (its prompt and the reference's tokens so far as a new
prompt), so that every later token is compared too. The number of ties
a case may have is pinned to the number observed (``TIES``, the same with
1 and 8 CPU threads): none for fp8-e4m3 and int8-auto; for fp8_w8a8-e5m2
5 of the batch's 60 tokens (request 2 step 2, margin 0.0086; request 3
steps 4, 7, 8 and 11, margins 0.013-0.036) and none in the 300-token
wave. A 32-token batch budget forces chunked
prefill, 12 new tokens per request run decode windows (M <= 256: the
kernels' plain versions); a 300-token prompt, chunked on the JAX side,
goes through the port once more in one wave (the M > 256 path)."""
import numpy as np
import pytest

from aphrodite_tpu.entrypoints.llm import LLM as JaxLLM
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.loader.weights import params_from_jax

MAX_TOKENS = 12
TIE = 5e-2
CASES = {"fp8-e4m3": ("fp8", "fp8_e4m3"),
         "fp8_w8a8-e5m2": ("fp8_w8a8", "fp8_e5m2"),
         "int8-auto": ("int8", "auto")}
# The ties each case may have: (the batch, the 300-token wave).
TIES = {"fp8-e4m3": (0, 0), "fp8_w8a8-e5m2": (5, 0), "int8-auto": (0, 0)}


def _kwargs(quant, kv, budget):
    from transformers import Qwen2Config
    hf = Qwen2Config(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=8, num_key_value_heads=2,
                     intermediate_size=256, max_position_embeddings=512,
                     rms_norm_eps=1e-5, tie_word_embeddings=False,
                     architectures=["Qwen2ForCausalLM"])
    return dict(hf_config=hf, tokenizer="unused", dtype="float32",
                load_format="dummy", device="cpu", quantization=quant,
                kv_cache_dtype=kv, block_size=16, num_kv_blocks=128,
                max_num_seqs=4, max_num_batched_tokens=budget,
                max_model_len=384)


def _margin(step: dict) -> float:
    """The reference's top-2 logprob margin at one step."""
    vals = sorted((getattr(v, "logprob", v) for v in step.values()),
                  reverse=True)
    return vals[0] - vals[1] if len(vals) > 1 else float("inf")


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    quant, kv = CASES[request.param]
    ties = TIES[request.param]
    jax_llm = JaxLLM("dummy", **_kwargs(quant, kv, 32))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 500, size=n).tolist()
               for n in (5, 40, 17, 3, 300)]
    outs = jax_llm.generate(prompts, JaxParams(
        temperature=0.0, max_tokens=MAX_TOKENS, ignore_eos=True,
        logprobs=2))
    tokens = [o.outputs[0].token_ids for o in outs]
    margins = [[_margin(s) for s in o.outputs[0].logprobs] for o in outs]
    return (quant, kv, jax_llm.engine.core.worker.params, prompts, tokens,
            margins, ties)


def _port(quant, kv, tree, budget):
    port = LLM("dummy", **_kwargs(quant, kv, budget))
    port.engine.core.worker.load_params(params_from_jax(tree))
    return port


def _generate(port, prompts, max_tokens=MAX_TOKENS):
    outs = port.generate(prompts, SamplingParams(
        temperature=0.0, max_tokens=max_tokens, ignore_eos=True))
    return [o.outputs[0].token_ids for o in outs]


def assert_tokens_match(port, prompts, want, margins, got, most):
    """Every token identical but at ties, at most ``most`` of them (the
    module docstring): past one, the port goes on from the reference's
    tokens."""
    ties = []
    for r, (a, m) in enumerate(zip(want, margins)):
        b, start = got[r], 0
        while True:
            i = next((i for i in range(start, len(a)) if a[i] != b[i - start]),
                     None)
            if i is None:
                break
            assert m[i] < TIE, (f"request {r} step {i}: {b[i - start]} "
                                f"against the reference's {a[i]}, whose "
                                f"margin {m[i]:.3g} >= {TIE}")
            ties.append((r, i))
            start = i + 1
            if start == len(a):
                break
            b = _generate(port, [prompts[r] + a[:start]], len(a) - start)[0]
    assert len(ties) <= most, ties


def test_fp8_greedy_tokens_match_jax(case):
    quant, kv, tree, prompts, want, margins, ties = case
    port = _port(quant, kv, tree, 32)
    runner = port.engine.core.worker.runner
    assert str(runner.kv_cache.dtype) == {
        "fp8_e4m3": "torch.float8_e4m3fn", "fp8_e5m2": "torch.float8_e5m2",
        "auto": "torch.float32"}[kv]
    assert_tokens_match(port, prompts, want, margins,
                        _generate(port, prompts), ties[0])


def test_fp8_prefill_wave_over_256_tokens(case):
    quant, kv, tree, prompts, want, margins, ties = case
    assert len(prompts[-1]) > 256
    port = _port(quant, kv, tree, 512)
    assert_tokens_match(port, prompts[-1:], want[-1:], margins[-1:],
                        _generate(port, prompts[-1:]), ties[1])
