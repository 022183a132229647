"""The port's ``LLM.generate`` vs ``aphrodite_tpu.LLM`` on the same weights
for Gemma, Gemma-2 and Gemma-3 (text): the JAX engine's dummy tree, redrawn
at fan-in scale (``test_torch_gemma.perturb``), is loaded into both
engines, the port's through ``params_from_jax``.

Greedy token ids must be identical (fp32). Decode windows run the runner's
non-window multi-step path (``_execute_multi_step``: these models have no
window decode) with a window of 16 and single-step decode; a 16-token batch
budget cuts the prompts into chunks; prompts run past the 16-token sliding
window; ragged ``max_tokens`` freeze rows inside the windows; a second
pass hits the prefix cache and gives the same tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aphrodite_tpu.entrypoints.llm import LLM as JaxLLM
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.loader.weights import params_from_jax

from tests.test_torch_gemma import ARCHS, gemma_config, perturb

MAX_TOKENS = (12, 5, 20, 9)
PROMPT_LENS = (5, 40, 17, 33)


def _kwargs(arch, **kw):
    return {**dict(hf_config=gemma_config(arch), tokenizer="unused",
                   dtype="float32", load_format="dummy", device="cpu",
                   block_size=16, num_kv_blocks=128, max_num_seqs=4,
                   max_num_batched_tokens=16, max_model_len=256), **kw}


@pytest.fixture(scope="module", params=ARCHS)
def engines(request):
    arch = request.param
    jax_llm = JaxLLM("dummy", **_kwargs(arch))
    worker = jax_llm.engine.core.worker
    tree = perturb(worker.params, 11)
    worker.params = worker.runner.params = jax.tree.map(jnp.asarray, tree)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 250, size=n).tolist() for n in PROMPT_LENS]
    jax_tokens = [o.outputs[0].token_ids for o in jax_llm.generate(
        prompts, [JaxParams(temperature=0.0, max_tokens=n, ignore_eos=True)
                  for n in MAX_TOKENS])]
    ports = {}
    for window in (16, 1):
        port = LLM("dummy", decode_window=window, **_kwargs(arch))
        port.engine.core.worker.load_params(params_from_jax(tree))
        ports[window] = port
    return jax_tokens, ports, prompts


def _generate(port, prompts):
    return port.generate(prompts, [
        SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True)
        for n in MAX_TOKENS])


@pytest.mark.parametrize("window", [16, 1])
def test_greedy_tokens_identical(engines, window):
    jax_tokens, ports, prompts = engines
    runner = ports[window].engine.core.worker.runner
    calls = []
    multi_step = runner._execute_multi_step

    def counted(*a, **kw):
        calls.append(a[1])
        return multi_step(*a, **kw)
    runner._execute_multi_step = counted
    outs = _generate(ports[window], prompts)
    assert [o.outputs[0].token_ids for o in outs] == jax_tokens
    assert [len(t) for t in jax_tokens] == list(MAX_TOKENS)
    # Decode went through the multi-step path exactly when windows are on.
    assert (max(calls, default=1) > 1) == (window > 1)
    # Not a fixed point of the weights: the tokens vary.
    assert len({t for toks in jax_tokens for t in toks}) > 10
    again = _generate(ports[window], prompts)
    assert [o.outputs[0].token_ids for o in again] == jax_tokens
    assert any(o.num_cached_tokens > 0 for o in again)
    assert ports[window].engine.reset_prefix_cache()
    runner._execute_multi_step = multi_step
