"""The port's DeepSeek V2/V3 pieces vs the JAX package's on the same numpy
inputs (fp32):

- ``deepseek_routing`` vs the JAX model's ``_route`` (V2 greedy and
  group-limited, V3's sigmoid with its score correction and norm_topk):
  equal experts, weights to 1e-6;
- a DeepSeek-MoE MLP vs ``_moe_mlp`` on both sides of the T * k >= 4E
  rule: atol 1e-5 (the port sums experts in another order: ROADMAP C);
- ``params_from_jax`` covers the port's state dict, ``w_uk`` / ``w_uv``
  permuted;
- a prefill wave and a decode-window sub-step of tiny V2 (plain, q_lora,
  group-limited) and V3 models with non-trivial norms, DeepSeek-YaRN rope:
  logits and hidden states to 1e-4, the latent K/V written to 1e-5;
- the geometry (one 576-wide latent KV head, the scale from qk_head_dim)
  and what still raises (quantized DeepSeek, MiniCPM3), while an fp8
  cache and fp16 at the MLA geometry size the MLA instances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.attention.metadata import AttentionMetadata as JaxMD
from aphrodite_tpu.config import ModelConfig as JaxModelConfig
from aphrodite_tpu.loader.weights import create_model as jax_create_model
from aphrodite_tpu_torch import LLM
from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.config import ModelConfig
from aphrodite_tpu_torch.loader.weights import (create_model, load_params,
                                                params_from_jax)
from aphrodite_tpu_torch.models import moe_common
from aphrodite_tpu_torch.ops.ragged_paged_attention import (
    ragged_work_item_tokens)

from tests.utils import make_prefill_metadata

YARN = {"type": "yarn", "factor": 40.0,
        "original_max_position_embeddings": 128, "beta_fast": 32.0,
        "beta_slow": 1.0, "mscale": 0.707, "mscale_all_dim": 0.707}


def ds_config(arch="DeepseekV2ForCausalLM", layers=3, **kw):
    """A tiny DeepSeek (hidden 64, 4 heads, latent 32 + rope 8, 8 experts
    top-2 with shared experts, a dense first layer, DeepSeek-YaRN)."""
    import transformers as tf
    base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=layers,
                num_attention_heads=4, num_key_value_heads=4,
                intermediate_size=96, kv_lora_rank=32, q_lora_rank=None,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                max_position_embeddings=512, tie_word_embeddings=False,
                n_routed_experts=8, num_experts_per_tok=2,
                moe_intermediate_size=32, n_shared_experts=1,
                first_k_dense_replace=1, rope_scaling=dict(YARN),
                architectures=[arch])
    base.update(kw)
    if arch == "DeepseekV3ForCausalLM":
        base.setdefault("n_group", 4)
        base.setdefault("topk_group", 2)
        return tf.DeepseekV3Config(**base)
    return tf.DeepseekV2Config(**base)


CONFIGS = {
    "v2": dict(),
    "v2-qlora-group-limited": dict(q_lora_rank=24, n_group=4, topk_group=2,
                                   topk_method="group_limited_greedy",
                                   n_shared_experts=2,
                                   routed_scaling_factor=2.0),
    "v3": dict(arch="DeepseekV3ForCausalLM", q_lora_rank=24,
               norm_topk_prob=True, routed_scaling_factor=2.5),
}


def _perturb(tree, rng):
    """Non-trivial norms, O(1)-scale router and experts, a random V3
    correction bias: every term shows in the outputs."""
    def stack(s):
        out = dict(s)
        for k, v in s.items():
            a = np.asarray(v)
            if "norm" in k:
                out[k] = jnp.asarray(1 + 0.2 * rng.randn(*a.shape)
                                     .astype(np.float32))
            elif k == "router_bias":
                out[k] = jnp.asarray(0.3 * rng.randn(*a.shape)
                                     .astype(np.float32))
            elif k.startswith(("router", "we_", "ws_")):
                out[k] = jnp.asarray(0.3 * rng.randn(*a.shape)
                                     .astype(np.float32))
        return out
    out = {**tree, "layers": stack(tree["layers"])}
    for key in ("moe", "dense_mlp"):
        if key in tree:
            out[key] = stack(tree[key])
    return out


def _models(hf, seed=0):
    jmodel = jax_create_model(JaxModelConfig(
        model="dummy", hf_config=hf, tokenizer="unused", dtype="float32"))
    params = _perturb(jmodel.init_dummy_params(jax.random.PRNGKey(seed)),
                      np.random.RandomState(seed + 10))
    tmodel = create_model(ModelConfig(model="dummy", hf_config=hf,
                                      dtype="float32"), "cpu")
    load_params(tmodel, params_from_jax(params, tmodel.layer_kinds))
    return jmodel, params, tmodel


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    kw = dict(CONFIGS[request.param])
    return _models(ds_config(kw.pop("arch", "DeepseekV2ForCausalLM"), **kw))


# ----------------------------------------------------------------- routing
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_routing_matches(name):
    kw = dict(CONFIGS[name])
    jmodel, params, tmodel = _models(
        ds_config(kw.pop("arch", "DeepseekV2ForCausalLM"), layers=2, **kw))
    mp = {k: v[0] for k, v in params["moe"].items()}
    h = np.random.RandomState(3).randn(40, 64).astype(np.float32)
    jw, ji = jmodel._route(jnp.asarray(h), mp)
    moe = tmodel.layers[1].moe
    ti, tw = moe_common.deepseek_routing(
        torch.from_numpy(h), moe.router, tmodel.top_k, tmodel.router_style,
        tmodel.n_group, tmodel.topk_group, tmodel.norm_topk,
        tmodel.routed_scaling, moe.router_bias)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)


@pytest.mark.parametrize("T", [4, 40])  # dense and grouped routes (E = 8)
def test_moe_mlp_matches(T, monkeypatch):
    monkeypatch.setenv("APHRODITE_PALLAS_INTERPRET", "1")
    jmodel, params, tmodel = _models(ds_config(
        "DeepseekV3ForCausalLM", layers=2, q_lora_rank=24))
    lp = {k: v[0] for k, v in params["moe"].items()}
    h = (np.random.RandomState(4).randn(T, 64) * 0.5).astype(np.float32)
    want = jmodel._moe_mlp(jnp.asarray(h), lp)
    with torch.inference_mode():
        got = tmodel._mlp(tmodel.layers[1], torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ------------------------------------------------------------ whole models
BLOCK, MAXP = 16, 8


def test_params_cover_the_model(models):
    _, params, tmodel = models
    state = params_from_jax(params, tmodel.layer_kinds)
    assert sorted(state) == sorted(tmodel.state_dict())
    w_uk = np.asarray(params["layers"]["w_uk"])  # [L, R, nq, nope]
    np.testing.assert_array_equal(state["layers.1.w_uk"],
                                  w_uk[1].transpose(1, 2, 0))
    w_uv = np.asarray(params["layers"]["w_uv"])  # [L, R, nq, v]
    np.testing.assert_array_equal(state["layers.2.w_uv"],
                                  w_uv[2].transpose(1, 0, 2))


def test_geometry_and_scale(models):
    jmodel, _, tmodel = models
    assert (tmodel.num_kv_heads, tmodel.head_dim) == (1, 32 + 8) == (
        jmodel.num_kv_heads, jmodel.head_dim)
    assert tmodel.scale == jmodel.scale != tmodel.head_dim ** -0.5
    assert tmodel.rope_mscale == jmodel._rope_mscale
    np.testing.assert_array_equal(tmodel.inv_freq.numpy(),
                                  np.asarray(jmodel._inv_freq))
    assert tmodel.layer_kinds == jmodel.layer_kinds


def _port_md(md):
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return AttentionMetadata(
        token_req_idx=t(md.token_req_idx), token_pos=t(md.token_pos),
        slot_mapping=t(np.asarray(md.slot_mapping, np.int64)),
        seq_lens=t(md.seq_lens), block_tables=t(md.block_tables))


def test_prefill_and_window_match(models):
    """A 32-token prefill wave (the grouped route at 8 experts) then one
    decode-window sub-step of the four requests (the dense route)."""
    jmodel, params, tmodel = models
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 250, size=n).tolist() for n in (10, 7, 5, 3)]
    md, ids, used = make_prefill_metadata(prompts, BLOCK, MAXP,
                                          num_tokens_pad=32)
    L, kvh, hd = jmodel.num_layers, jmodel.num_kv_heads, jmodel.head_dim
    jcache = jnp.zeros((L, used + 2, 2, kvh, BLOCK, hd), jnp.float32)
    ids_np = np.asarray(ids, np.int32)
    jh, jcache = jmodel.apply(params, jnp.asarray(ids_np), jcache, md)
    tcache = torch.zeros(tuple(jcache.shape), dtype=torch.float32)
    with torch.inference_mode():
        th = tmodel(torch.from_numpy(ids_np.astype(np.int64)), tcache,
                    _port_md(md))
    T = sum(len(p) for p in prompts)
    last = np.cumsum([len(p) for p in prompts]) - 1
    jl = jmodel.compute_logits(params, jh[last])
    with torch.inference_mode():
        tl = tmodel.compute_logits(th[torch.from_numpy(last)])
    np.testing.assert_allclose(th.numpy()[:T], np.asarray(jh)[:T], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tcache.numpy()[:, 1:],
                               np.asarray(jcache)[:, 1:], rtol=0, atol=1e-5)

    R, step, Kw = len(prompts), 2, 4
    tails = (rng.randn(2, L, R, kvh, Kw, hd) * 0.3).astype(np.float32)
    tails[:, :, :, :, step:] = 0
    paged = np.asarray([len(p) for p in prompts], np.int32)
    toks = rng.randint(1, 250, size=R).astype(np.int32)
    bt = np.array(md.block_tables)
    jmd = JaxMD(
        token_req_idx=jnp.arange(R, dtype=jnp.int32),
        token_pos=jnp.asarray(paged + step),
        slot_mapping=jnp.full((R,), -1, jnp.int32),
        query_start_loc=jnp.arange(R + 1, dtype=jnp.int32),
        seq_lens=jnp.asarray(paged + step + 1),
        block_tables=jnp.asarray(bt),
        num_reqs=jnp.asarray(R, jnp.int32),
        num_tokens=jnp.asarray(R, jnp.int32), decode_mode=True,
        window_step=jnp.int32(step), paged_lens=jnp.asarray(paged))
    jh, (_, jtk, jtv) = jmodel.apply(
        params, jnp.asarray(toks), (jcache, jnp.asarray(tails[0]),
                                    jnp.asarray(tails[1])), jmd)
    t = torch.from_numpy
    tmd = AttentionMetadata(
        token_req_idx=torch.arange(R, dtype=torch.int32),
        token_pos=t(paged + step), slot_mapping=None,
        seq_lens=t(paged + step + 1), block_tables=t(bt),
        window_step=step, paged_lens=t(paged))
    ttk, ttv = t(tails[0].copy()), t(tails[1].copy())
    with torch.inference_mode():
        tl = tmodel.compute_logits(tmodel.forward_window(
            t(toks.astype(np.int64)), tcache, ttk, ttv, tmd))
    np.testing.assert_allclose(tl.numpy(),
                               np.asarray(jmodel.compute_logits(params, jh)),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(ttk.numpy(), np.asarray(jtk), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ttv.numpy(), np.asarray(jtv), rtol=0,
                               atol=1e-5)


# ------------------------------------ what still raises, and what no longer
def _llm(hf, **kw):
    return LLM("dummy", hf_config=hf, tokenizer="unused", device="cpu",
               block_size=16, num_kv_blocks=16, max_num_seqs=2,
               max_num_batched_tokens=32, max_model_len=64,
               **{"dtype": "float32", **kw})


def test_engine_geometry():
    llm = _llm(ds_config())
    runner = llm.engine.core.worker.runner
    assert tuple(runner.kv_cache.shape) == (3, 16, 2, 1, 16, 40)
    mc = llm.engine.config.model_config
    assert mc.uses_mla and (mc.num_kv_heads, mc.head_dim) == (1, 40)


@pytest.mark.parametrize("quant", ["gptq", "w8a16", "fp8"])
def test_quantized_deepseek_raises(quant):
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        _llm(ds_config(), quantization=quant)


def test_mla_instances_take_fp8_caches_and_fp16():
    """An fp8 cache at the MLA geometry and fp16 queries at head_dim 576
    raise nowhere: bf16 and fp16 at 576 size the MLA instances on a cache
    of their own dtype and on e4m3 and e5m2 caches alike (4 tokens a work
    item at V2-Lite's group of 16), and engines with an e4m3 cache (bf16)
    and in fp16 build; fp32 runs the scalar instances, which take fp8
    too."""
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_route, ragged_uses_mla)
    from aphrodite_tpu_torch.ops.window_decode_attention import (
        window_uses_mla)
    hf = ds_config(kv_lora_rank=512, qk_rope_head_dim=64)
    runner = _llm(hf, dtype="bfloat16",
                  kv_cache_dtype="fp8").engine.core.worker.runner
    assert runner.kv_cache.dtype == torch.float8_e4m3fn
    runner = _llm(hf, dtype="float16").engine.core.worker.runner
    assert runner.kv_cache.dtype == torch.float16
    for dt in (torch.bfloat16, torch.float16):
        assert ragged_uses_mla(dt, 576) and window_uses_mla(dt, 576)
        # DeepSeek's calls (no spans, no ALiBi) keep the instances
        # without options.
        assert ragged_route(dt, 576, False, False)[0] in (
            "mla_attention", "mla_attention_f16")
        for kv in (None, torch.float8_e4m3fn, torch.float8_e5m2):
            assert ragged_work_item_tokens(dt, 16, 576, 232448, kv) == 4
    for kv in (torch.float8_e4m3fn, torch.float8_e5m2):
        assert ragged_work_item_tokens(torch.float32, 16, 576, 232448,
                                       kv) == 1


def test_minicpm3_is_not_ported():
    hf = ds_config(architectures=["MiniCPM3ForCausalLM"])
    with pytest.raises(NotImplementedError, match="MiniCPM3ForCausalLM"):
        _llm(hf)
