"""The port's ``LLM.generate`` vs ``aphrodite_tpu.LLM`` on the same weights
for each sparse-MoE architecture (Mixtral, Qwen2-MoE, Qwen3-MoE, OLMoE,
DeepSeek V1 with a dense first layer): the JAX engine's tree goes through
``params_from_jax`` into the port's worker, as in ``test_torch_llm.py``.

Greedy token ids must be identical (fp32). With 8 experts and top-2 the
grouped route starts at 16 tokens; a 32-token batch budget makes prefill
waves on both sides of it (32-token chunks and shorter ends), decode
windows take the dense route, and a second pass hits the prefix cache."""
import numpy as np
import pytest

from aphrodite_tpu.entrypoints.llm import LLM as JaxLLM
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.loader.weights import params_from_jax
from aphrodite_tpu_torch.models import moe_common

from tests.test_torch_moe import ARCHS, moe_config

MAX_TOKENS = 12


def _kwargs(arch, **kw):
    return dict(hf_config=moe_config(arch), tokenizer="unused",
                dtype="float32", load_format="dummy", device="cpu",
                block_size=16, num_kv_blocks=128, max_num_seqs=4,
                max_num_batched_tokens=32, max_model_len=256, **kw)


@pytest.fixture(scope="module", params=ARCHS)
def engines(request):
    jax_llm = JaxLLM("dummy", **_kwargs(request.param))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 500, size=n).tolist()
               for n in (5, 40, 17, 70, 3, 33)]
    jax_tokens = [o.outputs[0].token_ids for o in jax_llm.generate(
        prompts, JaxParams(temperature=0.0, max_tokens=MAX_TOKENS,
                           ignore_eos=True))]
    port = LLM("dummy", **_kwargs(request.param))
    model = port.engine.core.worker.model
    port.engine.core.worker.load_params(params_from_jax(
        jax_llm.engine.core.worker.params, model.layer_kinds))
    return jax_tokens, port, prompts


def test_greedy_tokens_identical(engines, monkeypatch):
    jax_tokens, port, prompts = engines
    routes = {"_grouped_moe": 0, "_dense_moe": 0}
    for fn in routes:
        real = getattr(moe_common, fn)

        def counted(*a, _f=real, _n=fn):
            routes[_n] += 1
            return _f(*a)
        monkeypatch.setattr(moe_common, fn, counted)
    params = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS,
                            ignore_eos=True)
    outs = port.generate(prompts, params)
    assert [o.outputs[0].token_ids for o in outs] == jax_tokens
    assert min(routes.values()) > 0, routes
    again = port.generate(prompts, params)
    assert [o.outputs[0].token_ids for o in again] == jax_tokens
    assert any(o.num_cached_tokens > 0 for o in again)


@pytest.mark.parametrize("quant", ["gptq", "w8a16"])
def test_quantized_moe_engine_raises(quant):
    with pytest.raises(NotImplementedError, match="quantized experts"):
        LLM("dummy", **_kwargs("Qwen2MoeForCausalLM", quantization=quant))
