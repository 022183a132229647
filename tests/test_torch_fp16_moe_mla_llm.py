"""The port's ``LLM.generate`` in fp16 vs ``aphrodite_tpu.LLM`` in fp16 on
the same weights (the JAX engine's tree through ``params_from_jax``): tiny
DeepSeek V2 and V3 (MLA as MQA over one latent head; a dense first layer,
then DeepSeek-MoE) and a tiny Qwen2-MoE, one JAX engine a model
(module-scoped), three short prompts, 8 new tokens each.

A 32-token batch budget makes prefill waves on both sides of the grouped
route's T * k >= 4E = 32 rows (top-2 of 8): the port's grouped GEMM
(its plain version here; ``csrc/grouped_matmul_f16.cu`` on the card)
against the reference's expert scan (DeepSeek, ``deepseek.py:457-480``)
and its ``ragged_dot`` route (Qwen2-MoE: megablox ``gmm`` refuses fp16
operands, so the reference's Pallas route raises in fp16 and its XLA
route is the one that computes; ``test_torch_fp16_moe_mla.py`` pins the
refusal). Decode windows take the dense route.

Tokens must be identical but at ties: both engines round weights and
activations to fp16 at their own points, so where the reference's top-2
logprob margin is below ``TIE`` = 5e-2 a request may take the other token
and then goes on from the reference's (``test_torch_fp8_llm.py``'s rule,
``assert_tokens_match``); the number of such ties is pinned to the number
observed (``TIES``)."""
import numpy as np
import pytest
import torch

from aphrodite_tpu.entrypoints.llm import LLM as JaxLLM
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.loader.weights import params_from_jax
from aphrodite_tpu_torch.models import moe_common

from tests.test_torch_deepseek import CONFIGS, ds_config
from tests.test_torch_fp8_llm import _margin, assert_tokens_match
from tests.test_torch_moe import moe_config

MAX_TOKENS = 8
MODELS = ("deepseek-v2", "deepseek-v3", "qwen2-moe")
# The ties each model may have in its 24 tokens: the number observed.
TIES = {"deepseek-v2": 0, "deepseek-v3": 0, "qwen2-moe": 0}


def _hf(name):
    if name == "qwen2-moe":
        return moe_config("Qwen2MoeForCausalLM")
    kw = dict(CONFIGS[name.removeprefix("deepseek-")])
    return ds_config(kw.pop("arch", "DeepseekV2ForCausalLM"), **kw)


def _kwargs(name):
    return dict(hf_config=_hf(name), tokenizer="unused", dtype="float16",
                load_format="dummy", device="cpu", block_size=16,
                num_kv_blocks=64, max_num_seqs=4,
                max_num_batched_tokens=32, max_model_len=128)


@pytest.fixture(scope="module", params=MODELS)
def engines(request):
    name = request.param
    rng = np.random.RandomState(21)
    prompts = [rng.randint(1, 250, size=n).tolist() for n in (5, 40, 17)]
    # The reference's XLA route, whatever another test of this process left
    # in the environment: its Pallas route raises on fp16.
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APHRODITE_PALLAS_INTERPRET", "0")
        jax_llm = JaxLLM("dummy", **_kwargs(name))
        outs = jax_llm.generate(prompts, JaxParams(
            temperature=0.0, max_tokens=MAX_TOKENS, ignore_eos=True,
            logprobs=2))
    want = [o.outputs[0].token_ids for o in outs]
    margins = [[_margin(s) for s in o.outputs[0].logprobs] for o in outs]
    port = LLM("dummy", **_kwargs(name))
    model = port.engine.core.worker.model
    port.engine.core.worker.load_params(params_from_jax(
        jax_llm.engine.core.worker.params, model.layer_kinds))
    return name, port, prompts, want, margins


def test_fp16_greedy_tokens_match_jax(engines, monkeypatch):
    name, port, prompts, want, margins = engines
    assert port.engine.core.worker.runner.kv_cache.dtype == \
        port.engine.core.worker.model.embed.dtype == torch.float16
    routes = {"_grouped_moe": 0, "_dense_moe": 0}
    for fn in routes:
        real = getattr(moe_common, fn)

        def counted(*a, _f=real, _n=fn):
            routes[_n] += 1
            return _f(*a)
        monkeypatch.setattr(moe_common, fn, counted)
    got = [o.outputs[0].token_ids for o in port.generate(
        prompts, SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS,
                                ignore_eos=True))]
    assert min(routes.values()) > 0, routes
    assert len({t for x in want for t in x}) > 3, want
    assert_tokens_match(port, prompts, want, margins, got, TIES[name])
