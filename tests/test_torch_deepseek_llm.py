"""The port's ``LLM.generate`` vs ``aphrodite_tpu.LLM`` on the same weights
for DeepSeek V2 (no q_lora, greedy routing; q_lora with group-limited
routing) and V3 (sigmoid routing with its score correction), each tiny,
with a dense first layer and DeepSeek-YaRN rope: the JAX engine's tree goes
through ``params_from_jax`` into the port's worker.

Greedy token ids must be identical (fp32). A 32-token batch budget makes
prefill waves on both sides of the grouped route's 4E = 32 rows, decode
windows (``forward_window``: the latent rows ride the tails) take the dense
route, and on the V2 engine a second batch whose three requests share a
64-token (4-page) prompt runs the cascade: the shared-prefix pass at the
576-wide latent head's geometry, then the window from its state."""
import numpy as np
import pytest

from aphrodite_tpu.entrypoints.llm import LLM as JaxLLM
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.loader.weights import params_from_jax

from tests.test_torch_deepseek import CONFIGS, ds_config

MAX_TOKENS = 12


def _kwargs(name):
    kw = dict(CONFIGS[name])
    return dict(hf_config=ds_config(kw.pop("arch", "DeepseekV2ForCausalLM"),
                                    **kw),
                tokenizer="unused", dtype="float32", load_format="dummy",
                device="cpu", block_size=16, num_kv_blocks=128,
                max_num_seqs=4, max_num_batched_tokens=32, max_model_len=256)


def _prompt_sets():
    rng = np.random.RandomState(0)
    plain = [rng.randint(1, 250, size=n).tolist() for n in (5, 40, 17, 70)]
    shared = rng.randint(10, 200, size=64).tolist()  # 4 whole pages
    cascade = [shared + rng.randint(10, 200, size=3 + i).tolist()
               for i in range(3)]
    return {"plain": plain, "cascade": cascade}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def engines(request):
    jax_llm = JaxLLM("dummy", **_kwargs(request.param))
    sets = _prompt_sets()
    if request.param != "v2":
        del sets["cascade"]
    params = JaxParams(temperature=0.0, max_tokens=MAX_TOKENS,
                       ignore_eos=True)
    jax_tokens = {k: [o.outputs[0].token_ids
                      for o in jax_llm.generate(p, params)]
                  for k, p in sets.items()}
    port = LLM("dummy", **_kwargs(request.param))
    model = port.engine.core.worker.model
    port.engine.core.worker.load_params(params_from_jax(
        jax_llm.engine.core.worker.params, model.layer_kinds))
    return jax_tokens, port, sets


def test_greedy_tokens_identical(engines, monkeypatch):
    jax_tokens, port, sets = engines
    runner = port.engine.core.worker.runner
    found, windows = [], []
    detect = runner._detect_shared_prefix
    monkeypatch.setattr(runner, "_detect_shared_prefix",
                        lambda *a: found.append(detect(*a)) or found[-1])
    window = runner._execute_window
    monkeypatch.setattr(runner, "_execute_window",
                        lambda *a: windows.append(1) or window(*a))
    params = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS,
                            ignore_eos=True)
    for name, prompts in sets.items():
        found.clear()
        outs = port.generate(prompts, params)
        assert [o.outputs[0].token_ids for o in outs] == jax_tokens[name]
        if name == "cascade":  # the shared 4 pages took the cascade
            assert any(f is not None and f[1] == 64 for f in found), found
    assert windows
