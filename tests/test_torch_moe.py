"""The port's sparse-MoE pieces vs the JAX package's on the same numpy
inputs (fp32):

- the grouped GEMM's plain version (``ops/grouped_matmul.py``, what the
  CUDA wrapper runs on CPU tensors) vs megablox ``gmm`` in interpret mode
  and ``jax.lax.ragged_dot``, with empty groups, groups that are not a
  multiple of the row tile and one group holding most rows: atol 1e-5;
- ``softmax_topk_routing``: equal ``topi``, ``topw`` to 1e-6;
- ``moe_combine`` and a whole MoE block (routing, experts, the gated
  shared expert) on both sides of the T * k >= 4E rule, the grouped side
  with megablox in interpret mode as the JAX package's own tests run it:
  atol 1e-5 (the port sums the k rows of a token and the experts in
  another order than JAX);
- a prefill wave and a decode-window sub-step of each of the five MoE
  architectures, with non-trivial norms and biases: logits to 1e-4 and
  the K/V written to 1e-5, as in ``test_torch_llama.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.attention.metadata import AttentionMetadata as JaxMD
from aphrodite_tpu.config import ModelConfig as JaxModelConfig
from aphrodite_tpu.loader.weights import create_model as jax_create_model
from aphrodite_tpu.models import moe_common as jax_moe
from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.config import ModelConfig
from aphrodite_tpu_torch.loader.weights import (create_model, load_params,
                                                params_from_jax)
from aphrodite_tpu_torch.models import moe_common
from aphrodite_tpu_torch.ops.grouped_matmul import (grouped_matmul,
                                                    ref_grouped_matmul)

from tests.utils import make_prefill_metadata

ARCHS = ["MixtralForCausalLM", "Qwen2MoeForCausalLM", "Qwen3MoeForCausalLM",
         "OlmoeForCausalLM", "DeepseekForCausalLM"]


def moe_config(arch, vocab=512, layers=2, norm_topk=None, shared=None):
    """A tiny config of each MoE family (8 experts, top-2, hidden 64);
    DeepSeek V1's first layer is dense."""
    import transformers as tf
    common = dict(vocab_size=vocab, hidden_size=64, num_hidden_layers=layers,
                  num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=512, tie_word_embeddings=False,
                  num_experts_per_tok=2, architectures=[arch])
    if arch == "MixtralForCausalLM":
        return tf.MixtralConfig(intermediate_size=48, num_local_experts=8,
                                sliding_window=None, **common)
    if arch == "Qwen2MoeForCausalLM":
        return tf.Qwen2MoeConfig(
            intermediate_size=96, moe_intermediate_size=48, num_experts=8,
            shared_expert_intermediate_size=80 if shared is None else shared,
            norm_topk_prob=bool(norm_topk), **common)
    if arch == "Qwen3MoeForCausalLM":
        return tf.Qwen3MoeConfig(
            intermediate_size=96, moe_intermediate_size=48, num_experts=8,
            head_dim=16, norm_topk_prob=norm_topk is not False, **common)
    if arch == "OlmoeForCausalLM":
        return tf.OlmoeConfig(intermediate_size=48, num_experts=8,
                              norm_topk_prob=bool(norm_topk), **common)
    assert arch == "DeepseekForCausalLM"
    return tf.PretrainedConfig(
        model_type="deepseek", intermediate_size=96,
        moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=2,
        first_k_dense_replace=1, moe_layer_freq=1,
        norm_topk_prob=bool(norm_topk), rms_norm_eps=1e-6, **common)


# ------------------------------------------------------------ grouped GEMM
GMM_CASES = {  # group sizes, M = 128
    "empty-and-straddling": [20, 0, 45, 13, 0, 50],
    "one-group-most": [3, 118, 0, 7],
    "not-tile-multiples": [1, 31, 33, 63],
}


@pytest.mark.parametrize("name", sorted(GMM_CASES))
def test_grouped_matmul_plain_matches_megablox_and_ragged_dot(name):
    from jax.experimental.pallas.ops.tpu.megablox import gmm
    sizes = np.asarray(GMM_CASES[name], np.int32)
    E, M, K, N = len(sizes), int(sizes.sum()), 48, 80
    rng = np.random.RandomState(0)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(E, K, N) / np.sqrt(K)).astype(np.float32)
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    before = grouped_matmul.launches
    got = grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(off)).numpy()
    assert grouped_matmul.launches == before  # CPU: the plain version
    mb = gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes),
             preferred_element_type=jnp.float32, tiling=(32, K, N),
             interpret=True)
    rd = jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(sizes),
                            preferred_element_type=jnp.float32)
    np.testing.assert_allclose(got, np.asarray(mb), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(rd), rtol=0, atol=1e-5)


def test_grouped_matmul_bf16_rounds_once():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(40, 32).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(3, 32, 24).astype(np.float32)).bfloat16()
    off = torch.tensor([0, 10, 10, 40], dtype=torch.int32)
    got = ref_grouped_matmul(x, w, off)
    assert got.dtype == torch.bfloat16
    want = torch.cat([x[:10].float() @ w[0].float(),
                      x[10:].float() @ w[2].float()]).bfloat16()
    assert torch.equal(got, want)


# ----------------------------------------------------------------- routing
@pytest.mark.parametrize("norm_topk", [False, True])
def test_softmax_topk_routing_matches(norm_topk):
    rng = np.random.RandomState(2)
    h = rng.randn(24, 32).astype(np.float32)
    router = rng.randn(32, 8).astype(np.float32)
    ji, jw = jax_moe.softmax_topk_routing(jnp.asarray(h), jnp.asarray(router),
                                          3, norm_topk)
    ti, tw = moe_common.softmax_topk_routing(
        torch.from_numpy(h), torch.from_numpy(router), 3, norm_topk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)


# ------------------------------------------------------------ expert combine
E, H, INTER, TOP_K = 8, 32, 48, 2
ROUTES = {"dense": 8, "grouped": 64}  # T: T * k below / above 4E = 32


def _moe_inputs(T, seed):
    rng = np.random.RandomState(seed)
    h = (rng.randn(T, H) * 0.5).astype(np.float32)
    lp = {k: (rng.randn(*s) * 0.3).astype(np.float32) for k, s in (
        ("router", (H, E)), ("we_gate", (E, H, INTER)),
        ("we_up", (E, H, INTER)), ("we_down", (E, INTER, H)))}
    return h, lp


def _silu_mul(g, u):
    return jax.nn.silu(g) * u


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("norm_topk", [False, True])
def test_moe_combine_matches(monkeypatch, route, norm_topk):
    monkeypatch.setenv("APHRODITE_PALLAS_INTERPRET", "1")
    T = ROUTES[route]
    h, lp = _moe_inputs(T, seed=3)
    ji, jw = jax_moe.softmax_topk_routing(jnp.asarray(h),
                                          jnp.asarray(lp["router"]), TOP_K,
                                          norm_topk)
    want = jax_moe.moe_combine(jnp.asarray(h),
                               {k: jnp.asarray(v) for k, v in lp.items()},
                               _silu_mul, ji, jw, num_experts=E)
    calls = []
    for fn in ("_grouped_moe", "_dense_moe"):
        real = getattr(moe_common, fn)
        monkeypatch.setattr(moe_common, fn, lambda *a, _f=real, _n=fn: (
            calls.append(_n), _f(*a))[1])
    t = torch.from_numpy
    got = moe_common.moe_combine(
        t(h), t(np.concatenate([lp["we_gate"], lp["we_up"]], axis=-1)),
        t(lp["we_down"]), t(np.array(ji)).long(), t(np.array(jw)))
    assert calls == [f"_{route}_moe"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def _tree_with(jparams, rng, scale_layers=0.3):
    """The JAX tree with O(1)-scale expert/router weights and non-trivial
    norms and biases, so that every term shows in the outputs."""
    def perturb(stack):
        out = dict(stack)
        for k, v in stack.items():
            a = np.asarray(v)
            if "norm" in k:
                out[k] = jnp.asarray(1 + 0.2 * rng.randn(*a.shape)
                                     .astype(np.float32))
            elif k in ("bq", "bk", "bv"):
                out[k] = jnp.asarray(0.1 * rng.randn(*a.shape)
                                     .astype(np.float32))
            elif k.startswith(("router", "we_", "ws_")):
                out[k] = jnp.asarray(scale_layers * rng.randn(*a.shape)
                                     .astype(np.float32))
        return out
    tree = {**jparams, "layers": perturb(jparams["layers"])}
    for key in ("moe", "dense_mlp"):
        if key in jparams:
            tree[key] = perturb(jparams[key])
    return tree


def _models(hf, seed=0):
    jmodel = jax_create_model(JaxModelConfig(
        model="dummy", hf_config=hf, tokenizer="unused", dtype="float32"))
    params = _tree_with(jmodel.init_dummy_params(jax.random.PRNGKey(seed)),
                        np.random.RandomState(seed + 10))
    tmodel = create_model(ModelConfig(model="dummy", hf_config=hf,
                                      dtype="float32"), "cpu")
    load_params(tmodel, params_from_jax(params,
                                        getattr(tmodel, "layer_kinds", None)))
    return jmodel, params, tmodel


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("norm_topk", [False, True])
@pytest.mark.parametrize("shared", ["none", "gated"])
def test_moe_block_matches(monkeypatch, route, norm_topk, shared):
    """Qwen2-MoE's MLP (routing + experts [+ sigmoid-gated shared expert])
    of layer 0, JAX ``_mlp`` vs the port's."""
    monkeypatch.setenv("APHRODITE_PALLAS_INTERPRET", "1")
    hf = moe_config("Qwen2MoeForCausalLM", layers=1, norm_topk=norm_topk,
                    shared=80 if shared == "gated" else 0)
    jmodel, params, tmodel = _models(hf)
    lp = {k: v[0] for k, v in params["layers"].items()}
    assert ("ws_route" in lp) == (shared == "gated")
    T = ROUTES[route]
    h = (np.random.RandomState(4).randn(T, 64) * 0.5).astype(np.float32)
    want = jmodel._mlp(jnp.asarray(h), lp)
    with torch.inference_mode():
        got = tmodel._mlp(tmodel.layers[0], torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ------------------------------------------------------------ whole models
BLOCK, MAXP = 16, 8


def _port_md(md):
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return AttentionMetadata(
        token_req_idx=t(md.token_req_idx), token_pos=t(md.token_pos),
        slot_mapping=t(np.asarray(md.slot_mapping, np.int64)),
        seq_lens=t(md.seq_lens), block_tables=t(md.block_tables))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(moe_config(request.param))


def test_params_cover_the_model(models):
    _, params, tmodel = models
    state = params_from_jax(params, getattr(tmodel, "layer_kinds", None))
    assert sorted(state) == sorted(tmodel.state_dict())


def test_prefill_and_window_match(models):
    """A 32-token prefill wave (grouped route) then one decode-window
    sub-step of the four requests (dense route)."""
    jmodel, params, tmodel = models
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 500, size=n).tolist() for n in (10, 7, 5, 3)]
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
    toks = rng.randint(1, 500, size=R).astype(np.int32)
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
    jh, (_, jtk, _) = jmodel.apply(
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


def test_mixed_tree_needs_layer_kinds():
    hf = moe_config("DeepseekForCausalLM")
    jmodel = jax_create_model(JaxModelConfig(
        model="dummy", hf_config=hf, tokenizer="unused", dtype="float32"))
    params = jmodel.init_dummy_params(jax.random.PRNGKey(0))
    assert "moe" in params and "dense_mlp" in params
    with pytest.raises(ValueError, match="layer_kinds"):
        params_from_jax(params)
