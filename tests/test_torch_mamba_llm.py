"""The port's ``LLM.generate`` vs ``aphrodite_tpu.LLM`` on the same weights
for Mamba, FalconMamba and Mamba-2: the JAX engine's dummy tree, redrawn
at fan-in scale (``test_torch_mamba.perturb``), is loaded into both
engines, the port's through ``params_from_jax``.

Greedy token ids must be identical (fp32). Six prompts against
``max_num_seqs=4`` reuse state slots; a 16-token batch budget cuts the
longer prompts into chunks (conv and ssm state carried across each seam);
ragged ``max_tokens`` freeze rows inside decode windows; a decode window
of 16 and single-step decode give the same tokens; a second pass finds no
cached prompt tokens (prefix caching is off for recurrent-state models).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aphrodite_tpu.entrypoints.llm import LLM as JaxLLM
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.loader.weights import params_from_jax

from tests.test_torch_mamba import ARCHS, mamba_config, perturb

MAX_TOKENS = (12, 5, 9, 12, 3, 7)
PROMPT_LENS = (5, 40, 17, 33, 2, 21)


def _kwargs(arch, **kw):
    return {**dict(hf_config=mamba_config(arch), tokenizer="unused",
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
    outs = _generate(ports[window], prompts)
    assert [o.outputs[0].token_ids for o in outs] == jax_tokens
    assert [len(t) for t in jax_tokens] == list(MAX_TOKENS)
    # Not a fixed point of the dummy weights: the tokens vary.
    assert len({t for toks in jax_tokens for t in toks}) > 10
    again = _generate(ports[window], prompts)
    assert [o.outputs[0].token_ids for o in again] == jax_tokens
    assert all(o.num_cached_tokens == 0 for o in again)
    assert ports[window].engine.reset_prefix_cache()


def test_engine_settings_for_recurrent_state(engines):
    _, ports, _ = engines
    core = ports[16].engine.core
    assert not core.config.cache_config.enable_prefix_caching
    assert core.scheduler.num_lookahead_tokens == 0
    runner = core.worker.runner
    assert runner.is_ssm and set(runner.kv_cache) == {"conv", "ssm"}
    assert runner.kv_cache["ssm"].shape[1] == 4   # next_power_of_2(4)


def test_state_slot_stealing():
    """With every slot taken, a new request takes the slot of the first
    holder not scheduled in this step (``runner.py:1848-1863``); finishing
    frees a slot."""
    port = LLM("dummy", **_kwargs("MambaForCausalLM", max_num_seqs=2))
    runner = port.engine.core.worker.runner
    assert list(runner._ssm_state_slots(["a", "b"])) == [1, 0]
    assert list(runner._ssm_state_slots(["c", "a"])) == [0, 1]
    assert runner._slot_of == {"a": 1, "c": 0}
    from aphrodite_tpu_torch.core.sched_output import (CachedRequestData,
                                                       SchedulerOutput)
    runner.update_states(SchedulerOutput(
        scheduled_new_reqs=[], scheduled_cached_reqs=CachedRequestData(),
        num_scheduled_tokens={}, total_num_scheduled_tokens=0,
        finished_req_ids={"a"}))
    assert runner._free_slots == [1] and runner._slot_of == {"c": 0}
