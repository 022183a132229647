"""The port's Llama/Qwen2 model vs the JAX package's on the same weights
(``params_from_jax`` of the JAX dummy tree) and the same metadata.

Tolerance: fp32, atol 1e-4 on logits and hidden states, 1e-5 on the K/V
written into the cache (a 2-layer model; the frameworks order their
matmul sums differently)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.attention.metadata import AttentionMetadata as JaxMD
from aphrodite_tpu.config import ModelConfig as JaxModelConfig
from aphrodite_tpu.loader.weights import create_model as jax_create_model
from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.config import ModelConfig
from aphrodite_tpu_torch.loader.weights import (create_model, load_params,
                                                params_from_jax)

from tests.utils import make_prefill_metadata

BLOCK, MAXP = 16, 8


def _hf_config(arch):
    from transformers import LlamaConfig, Qwen2Config
    cls = Qwen2Config if arch == "Qwen2ForCausalLM" else LlamaConfig
    return cls(vocab_size=512, hidden_size=128, num_hidden_layers=2,
               num_attention_heads=8, num_key_value_heads=2,
               intermediate_size=256, max_position_embeddings=512,
               rms_norm_eps=1e-6, tie_word_embeddings=False,
               architectures=[arch])


@pytest.fixture(scope="module", params=["Qwen2ForCausalLM",
                                        "LlamaForCausalLM"])
def models(request):
    hf = _hf_config(request.param)
    jmodel = jax_create_model(JaxModelConfig(
        model="dummy", hf_config=hf, tokenizer="unused", dtype="float32"))
    params = jmodel.init_dummy_params(jax.random.PRNGKey(0))
    if jmodel.qkv_bias:  # non-zero biases so the bias path is exercised
        rng = np.random.RandomState(7)
        layers = dict(params["layers"])
        for b in ("bq", "bk", "bv"):
            layers[b] = jnp.asarray(
                rng.randn(*layers[b].shape).astype(np.float32) * 0.1)
        params = {**params, "layers": layers}
    tmodel = create_model(ModelConfig(model="dummy", hf_config=hf,
                                      dtype="float32"), "cpu")
    load_params(tmodel, params_from_jax(params))
    return jmodel, params, tmodel


def _port_md(md, slots):
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return AttentionMetadata(
        token_req_idx=t(md.token_req_idx), token_pos=t(md.token_pos),
        slot_mapping=t(np.asarray(slots, np.int64)),
        seq_lens=t(md.seq_lens),
        block_tables=t(md.block_tables))


def _prefill(models, seed=0):
    """__graft_entry__.entry()-style wave: four prompts, padded to 32."""
    jmodel, params, tmodel = models
    rng = np.random.RandomState(seed)
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
                    _port_md(md, np.asarray(md.slot_mapping)))
    return md, prompts, (jh, jcache), (th, tcache)


def test_prefill_logits_match(models):
    jmodel, params, tmodel = models
    md, prompts, (jh, jcache), (th, tcache) = _prefill(models)
    T = sum(len(p) for p in prompts)
    np.testing.assert_allclose(th.numpy()[:T], np.asarray(jh)[:T],
                               rtol=0, atol=1e-4)
    last = np.cumsum([len(p) for p in prompts]) - 1
    jl = jmodel.compute_logits(params, jh[last])
    with torch.inference_mode():
        tl = tmodel.compute_logits(th[torch.from_numpy(last)])
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    # Page 0 is the null page: the port parks pad tokens there.
    np.testing.assert_allclose(tcache.numpy()[:, 1:], np.asarray(jcache)[:, 1:],
                               rtol=0, atol=1e-5)


def test_merged_and_unmerged_trees_agree(models):
    jmodel, params, tmodel = models
    merged = params_from_jax(jmodel.maybe_merge_params(params))
    unmerged = params_from_jax(params)
    assert sorted(merged) == sorted(unmerged)
    for k in merged:
        np.testing.assert_array_equal(merged[k], unmerged[k])
    assert "layers.0.w_qkv" in merged and "layers.1.w_gate_up" in merged
    assert ("layers.0.b_qkv" in merged) == bool(jmodel.qkv_bias)


@pytest.mark.parametrize("step", [0, 3])
def test_window_substep_matches(models, step):
    jmodel, params, tmodel = models
    md, prompts, (_, jcache), (_, tcache) = _prefill(models, seed=1)
    R = len(prompts)
    L, kvh, hd, Kw = (jmodel.num_layers, jmodel.num_kv_heads,
                      jmodel.head_dim, 4)
    rng = np.random.RandomState(2)
    # Tail slots before `step` hold earlier sub-steps' K/V.
    tails = (rng.randn(2, L, R, kvh, Kw, hd) * 0.3).astype(np.float32)
    tails[:, :, :, :, step:] = 0
    paged = np.asarray([len(p) for p in prompts], np.int32)
    toks = rng.randint(1, 500, size=R).astype(np.int32)
    bt = np.asarray(md.block_tables)
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
        th = tmodel.forward_window(t(toks.astype(np.int64)), tcache, ttk,
                                   ttv, tmd)
        tl = tmodel.compute_logits(th)
    jl = jmodel.compute_logits(params, jh)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ttk.numpy(), np.asarray(jtk), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ttv.numpy(), np.asarray(jtv), rtol=0,
                               atol=1e-5)


def test_tied_embeddings_and_bf16_logits_are_fp32():
    hf = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
              num_attention_heads=2, num_key_value_heads=1,
              intermediate_size=64, tie_word_embeddings=True,
              architectures=["Qwen2ForCausalLM"])
    m = create_model(ModelConfig(model="dummy", hf_config=hf,
                                 dtype="bfloat16"), "cpu")
    assert m.lm_head is None
    m.init_dummy_params(torch.Generator().manual_seed(0))
    h = torch.randn(3, 32).bfloat16()
    with torch.inference_mode():
        out = m.compute_logits(h)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(
        out.numpy(), (h.float() @ m.embed.float().t()).numpy(), atol=1e-5)
