"""An fp8 KV cache at the MLA geometry (DeepSeek's one latent KV head of
576 lanes) in the PyTorch port vs the JAX package, on the same fp8 bytes:

- the ragged and window plain versions (which the CUDA wrappers run on
  CPU tensors, and which ``chip_smoke.py`` holds the fp8 MLA instances
  against) vs the Pallas kernels in interpret mode on e4m3 and e5m2
  caches, at the JAX runner's 640-lane padding (the first 576 lanes
  compared): ragged at groups 16 and 128, atol 1e-5; the window with
  e4m3's fp8 tails and e5m2's bf16 tails vs the JAX oracle on the same
  tails, atol 1e-5, vs the Pallas kernel on the tails upcast to fp32
  (exact), atol 1e-5, and vs the Pallas kernel on the tails themselves,
  atol 5e-3 (it rounds P to the tails' dtype before P V of the tail,
  ``p.astype(v.dtype)``; the port's versions do not, as
  ``tests/test_torch_fp8.py::test_window_fp8`` states);
- the launch sizing: the MLA instances take an fp8 cache in the bytes of
  their bf16 ring (231,008 of 232,448 at groups 16 and 128);
- tiny DeepSeek V2 on an e5m2 cache and V3 on an e4m3 cache through the
  port's ``LLM`` against ``aphrodite_tpu.LLM`` on the same weights:
  greedy tokens equal but at ties below the reference's 5e-2 margin (the
  rule of ``tests/test_torch_fp8_llm.py``), as many as observed
  (``TIES``);
- a bf16 engine at the real latent geometry (512 + 64) on each fp8 cache
  builds on the CPU, sizes the MLA instance and generates.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.entrypoints.llm import LLM as JaxLLM
from aphrodite_tpu.ops.window_decode_attention import (
    ref_window_decode_attention as jax_ref_window)
from aphrodite_tpu.ops.window_decode_attention import (
    window_decode_attention as jax_window_kernel)
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.loader.weights import params_from_jax
from aphrodite_tpu_torch.ops.cuda_build import H100_SMEM_OPTIN
from aphrodite_tpu_torch.ops.ragged_paged_attention import (
    mla_smem_bytes, ragged_work_item_tokens)
from aphrodite_tpu_torch.ops.window_decode_attention import (
    tail_dtype, window_decode_attention, window_launch_geometry,
    window_plan)

from tests.test_torch_deepseek import ds_config
from tests.test_torch_deepseek_llm import MAX_TOKENS, _kwargs, _prompt_sets
from tests.test_torch_fp8 import F8, to_torch
from tests.test_torch_fp8_llm import _margin, assert_tokens_match
from tests.test_torch_mla_attention import (HD, L, LAYER, PAGE, RAGGED,
                                            _pad, _ragged_inputs, _tables)

ATOL = 1e-5
KINDS = sorted(F8)


def _fp8(a: np.ndarray, kind: str):
    """``a`` cast to the fp8 ``kind`` by JAX at the 640-lane padding, and
    the same bytes' first 576 lanes as a torch tensor."""
    j = jnp.asarray(_pad(a)).astype(F8[kind][0])
    return j, to_torch(j)[..., :HD].contiguous()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", sorted(RAGGED))
def test_ragged_plain_matches_pallas_on_fp8(name, kind):
    nq, reqs = RAGGED[name]
    inp = _ragged_inputs(nq, reqs, np.random.RandomState(3))
    jc, tc = _fp8(inp["cache"], kind)
    got = inp["port"](torch.from_numpy(inp["q"]), tc).numpy()
    kern = np.asarray(inp["pallas"](jnp.asarray(_pad(inp["q"])), jc))
    np.testing.assert_array_equal(kern[..., HD:], 0)
    np.testing.assert_allclose(got, kern[..., :HD], rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", KINDS)
def test_window_plain_matches_jax_on_fp8(kind):
    rng = np.random.RandomState(4)
    nq, plens, step, kw = 16, [40, 13, 70], 2, 4
    R = len(plens)
    bt, P = _tables(rng, plens)
    jc, tc = _fp8((rng.randn(L, P, 2, 1, PAGE, HD) * 0.3).astype(np.float32),
                  kind)
    tdt = tail_dtype(F8[kind][1])
    assert tdt == {"e4m3": torch.float8_e4m3fn, "e5m2": torch.bfloat16}[kind]
    jtd = jnp.bfloat16 if tdt == torch.bfloat16 else F8[kind][0]
    tails = [jnp.asarray(_pad((rng.randn(L, R, 1, kw, HD) * 0.3).astype(
        np.float32))).astype(jtd) for _ in range(2)]
    tt = [to_torch(t)[..., :HD].contiguous() for t in tails]
    q = (rng.randn(R, nq, HD) * 0.3).astype(np.float32)
    pl, scale = np.asarray(plens, np.int32), 192 ** -0.5
    t = torch.from_numpy
    got = window_decode_attention(t(q), tc, tt[0], tt[1], LAYER, step, t(pl),
                                  t(bt), scale).numpy()
    ref = jax_ref_window(jnp.asarray(_pad(q)), jc[LAYER], tails[0][LAYER],
                         tails[1][LAYER], jnp.int32(step), jnp.asarray(pl),
                         jnp.asarray(bt), scale)
    np.testing.assert_allclose(got, np.asarray(ref)[..., :HD], rtol=0,
                               atol=ATOL)
    for tk, tv, atol in ((tails[0].astype(jnp.float32),
                          tails[1].astype(jnp.float32), ATOL),
                         (tails[0], tails[1], 5e-3)):
        kern = np.asarray(jax_window_kernel(
            jnp.asarray(_pad(q)), jc, tk, tv, jnp.int32(LAYER),
            jnp.int32(step), jnp.asarray(pl), jnp.asarray(bt), scale,
            chunk_pages=2, interpret=True))
        np.testing.assert_allclose(got, kern[..., :HD], rtol=0, atol=atol)


@pytest.mark.parametrize("group", [16, 128])
def test_mla_instances_take_an_fp8_cache(group):
    """The fp8 ring (two stages of 18,432-byte K and V tiles) and the two
    bf16 tiles it is converted into take the bf16 ring's 147,456 bytes:
    one block an SM on either cache, the same work items and plans."""
    assert mla_smem_bytes(fp8=True) == mla_smem_bytes() == 231008
    assert mla_smem_bytes(fp8=True) <= H100_SMEM_OPTIN
    for kv in (torch.float8_e4m3fn, torch.float8_e5m2):
        assert ragged_work_item_tokens(torch.bfloat16, group, HD,
                                       H100_SMEM_OPTIN, kv) == \
            max(1, 64 // group)
        assert window_launch_geometry(torch.bfloat16, group, HD,
                                      H100_SMEM_OPTIN, fp8=True) == \
            (True, 16, 231008)
        plan = window_plan(torch.bfloat16, 32, group, 1, HD, "cpu", 576, 62,
                           kv_dtype=kv)
        bf16 = window_plan(torch.bfloat16, 32, group, 1, HD, "cpu", 576, 62)
        assert plan.kv_dtype == kv and plan.rows == 64
        assert (plan.splits, plan.tiles_per_split) == \
            (bf16.splits, bf16.tiles_per_split)


# ------------------------------------------------------------- the engine
CACHES = {"e4m3": "fp8_e4m3", "e5m2": "fp8_e5m2"}
# The (config, cache) pairs, each config and each cache once (the card
# holds all four against the CPU, chip_smoke.py phase 23), and the ties
# each may have in its 48 tokens (see the module docstring): the number
# observed, the same on every run (V2 on e5m2: request 1, step 9; V2 on
# e4m3 and V3 on e5m2, run once each, had none).
TIES = {("v2", "e5m2"): 1, ("v3", "e4m3"): 0}


@pytest.mark.parametrize("case", sorted(TIES), ids="-".join)
def test_fp8_cache_greedy_tokens_match_jax(case):
    name, kind = case
    kw = dict(_kwargs(name), kv_cache_dtype=CACHES[kind])
    jax_llm = JaxLLM("dummy", **kw)
    prompts = _prompt_sets()["plain"]
    outs = jax_llm.generate(prompts, JaxParams(
        temperature=0.0, max_tokens=MAX_TOKENS, ignore_eos=True,
        logprobs=2))
    want = [o.outputs[0].token_ids for o in outs]
    margins = [[_margin(s) for s in o.outputs[0].logprobs] for o in outs]
    port = LLM("dummy", **kw)
    model = port.engine.core.worker.model
    port.engine.core.worker.load_params(params_from_jax(
        jax_llm.engine.core.worker.params, model.layer_kinds))
    assert port.engine.core.worker.runner.kv_cache.dtype == F8[kind][1]
    got = [o.outputs[0].token_ids for o in port.generate(
        prompts, SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS,
                                ignore_eos=True))]
    assert_tokens_match(port, prompts, want, margins, got, TIES[case])


@pytest.mark.parametrize("kv", ["fp8", "fp8_e4m3", "fp8_e5m2"])
def test_bf16_engine_at_the_latent_geometry_on_fp8(kv):
    hf = ds_config(kv_lora_rank=512, qk_rope_head_dim=64,
                   num_attention_heads=16, num_key_value_heads=16)
    llm = LLM("dummy", hf_config=hf, tokenizer="unused", device="cpu",
              dtype="bfloat16", kv_cache_dtype=kv, block_size=16,
              num_kv_blocks=16, max_num_seqs=2, max_num_batched_tokens=32,
              max_model_len=64)
    runner = llm.engine.core.worker.runner
    want = torch.float8_e5m2 if kv == "fp8_e5m2" else torch.float8_e4m3fn
    assert runner.kv_cache.dtype == want
    assert tuple(runner.kv_cache.shape[-2:]) == (16, 576)
    assert runner.tail_dtype == tail_dtype(want)
    assert runner.block_q == 4  # the MLA instance's, at a group of 16
    outs = llm.generate([[3, 1, 4, 1, 5], [9, 2, 6]], SamplingParams(
        temperature=0.0, max_tokens=5, ignore_eos=True))
    assert [len(o.outputs[0].token_ids) for o in outs] == [5, 5]
