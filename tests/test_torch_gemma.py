"""The port's Gemma, Gemma-2 and Gemma-3 (text) models vs the JAX package's
on the same weights (the JAX dummy tree redrawn at fan-in scale, loaded
through ``params_from_jax``) and the same metadata: a prefill wave with
prompts longer than the sliding window, then a decode-mode step (the path
the runner's multi-step decode takes, with the decode kernel's plain
version on the port's side).

Tolerance: fp32, atol 1e-4 on logits and hidden states, 1e-5 on the K/V
written into the cache (3 layers; the frameworks order their matmul sums
differently). Linear rope frequencies must equal the JAX ones bit for
bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.attention.metadata import AttentionMetadata as JaxMD
from aphrodite_tpu.config import ModelConfig as JaxModelConfig
from aphrodite_tpu.layers import rotary as jax_rotary
from aphrodite_tpu.loader.weights import create_model as jax_create_model
from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.config import ModelConfig
from aphrodite_tpu_torch.layers import rotary
from aphrodite_tpu_torch.loader.weights import (create_model, load_params,
                                                params_from_jax)

ARCHS = ["GemmaForCausalLM", "Gemma2ForCausalLM", "Gemma3ForCausalLM"]
BLOCK, WINDOW = 16, 16


def gemma_config(arch, vocab=256, layers=3):
    """A tiny config of each family: hidden 64, 4 query / 2 KV heads of 32,
    Gemma-2/3 with a 16-token sliding window (Gemma-3: 2 sliding layers,
    then a global one with linear rope scaling)."""
    import transformers as tf
    common = dict(vocab_size=vocab, hidden_size=64, num_hidden_layers=layers,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                  intermediate_size=128, max_position_embeddings=512,
                  architectures=[arch])
    if arch == "GemmaForCausalLM":
        return tf.GemmaConfig(**common)
    if arch == "Gemma2ForCausalLM":
        return tf.Gemma2Config(sliding_window=WINDOW,
                               query_pre_attn_scalar=24, **common)
    assert arch == "Gemma3ForCausalLM"
    return tf.Gemma3TextConfig(
        sliding_window=WINDOW, query_pre_attn_scalar=24,
        rope_scaling={"rope_type": "linear", "factor": 8.0},
        rope_local_base_freq=10000.0, layer_types=[
            "sliding_attention", "sliding_attention", "full_attention"],
        **common)


def perturb(tree, seed):
    """The JAX dummy tree with weights drawn at fan-in scale from a seeded
    numpy generator and norms (stored as w - 1) near 0. The dummy recipe's
    0.02 weights and unit norms make Gemma repeat its input token, and so
    does an embedding at fan-in scale, which the sqrt(hidden) input scale
    makes dominate the residual: the embedding is drawn 4x smaller. Leaves
    stay float32 numpy arrays; ``is_sliding`` is kept."""
    rng = np.random.RandomState(seed)
    H = np.asarray(tree["embed"]).shape[1]
    out = {"embed": (rng.randn(*np.asarray(tree["embed"]).shape)
                     / (4 * np.sqrt(H))).astype(np.float32),
           "final_norm": (0.1 * rng.randn(H)).astype(np.float32)}
    layers = {}
    for name, v in tree["layers"].items():
        shape = np.asarray(v).shape
        if name == "is_sliding":
            layers[name] = np.asarray(v)
        elif "norm" in name:
            layers[name] = (0.1 * rng.randn(*shape)).astype(np.float32)
        else:  # [L, fan_in, fan_out] projections
            layers[name] = (rng.randn(*shape)
                            / np.sqrt(shape[1])).astype(np.float32)
    out["layers"] = layers
    return out


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    hf = gemma_config(request.param)
    jmodel = jax_create_model(JaxModelConfig(
        model="dummy", hf_config=hf, tokenizer="unused", dtype="float32"))
    params = perturb(jmodel.init_dummy_params(jax.random.PRNGKey(0)), 3)
    tmodel = create_model(ModelConfig(model="dummy", hf_config=hf,
                                      dtype="float32"), "cpu")
    load_params(tmodel, params_from_jax(params))
    return jmodel, jax.tree.map(jnp.asarray, params), tmodel


def _layout(lens):
    """Block tables with one spare page per request for the decode token
    (page 0 is the null page), and each position's slot."""
    pages = [-(-(n + 1) // BLOCK) for n in lens]
    bt = np.zeros((len(lens), max(pages)), np.int32)
    nxt = 1
    for r, n in enumerate(pages):
        bt[r, :n] = np.arange(nxt, nxt + n)
        nxt += n
    slot = lambda r, p: bt[r, p // BLOCK] * BLOCK + p % BLOCK  # noqa: E731
    return bt, slot, nxt


def test_prefill_then_decode_mode_logits_match(models):
    jmodel, params, tmodel = models
    rng = np.random.RandomState(0)
    lens = [40, 23, 7, 18]           # two prompts past the 16-token window
    prompts = [rng.randint(1, 250, size=n) for n in lens]
    bt, slot, num_pages = _layout(lens)
    L, kvh, hd = jmodel.num_layers, jmodel.num_kv_heads, jmodel.head_dim
    jcache = jnp.zeros((L, num_pages, 2, kvh, BLOCK, hd), jnp.float32)
    tcache = torch.zeros(tuple(jcache.shape))
    t = torch.from_numpy

    # Prefill wave.
    tok_req = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    tok_pos = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    slots = np.asarray([slot(r, p) for r, p in zip(tok_req, tok_pos)],
                       np.int32)
    ids = np.concatenate(prompts).astype(np.int32)
    sl = np.asarray(lens, np.int32)
    qsl = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    jmd = JaxMD(token_req_idx=jnp.asarray(tok_req),
                token_pos=jnp.asarray(tok_pos),
                slot_mapping=jnp.asarray(slots),
                query_start_loc=jnp.asarray(qsl), seq_lens=jnp.asarray(sl),
                block_tables=jnp.asarray(bt),
                num_reqs=jnp.asarray(len(lens), jnp.int32),
                num_tokens=jnp.asarray(len(ids), jnp.int32))
    jh, jcache = jmodel.apply(params, jnp.asarray(ids), jcache, jmd)
    tmd = AttentionMetadata(token_req_idx=t(tok_req), token_pos=t(tok_pos),
                            slot_mapping=t(slots.astype(np.int64)),
                            seq_lens=t(sl), block_tables=t(bt))
    with torch.inference_mode():
        th = tmodel(t(ids.astype(np.int64)), tcache, tmd)
        last = t(qsl[1:].astype(np.int64) - 1)
        tl = tmodel.compute_logits(th[last])
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-4)
    jl = jmodel.compute_logits(params, jh[jnp.asarray(qsl[1:] - 1)])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache), rtol=0,
                               atol=1e-5)

    # One decode-mode step: each request's next token at position len.
    R = len(lens)
    toks = rng.randint(1, 250, size=R).astype(np.int32)
    pos = sl.copy()
    dslots = np.asarray([slot(r, p) for r, p in enumerate(pos)], np.int32)
    jmd = JaxMD(token_req_idx=jnp.arange(R, dtype=jnp.int32),
                token_pos=jnp.asarray(pos), slot_mapping=jnp.asarray(dslots),
                query_start_loc=jnp.arange(R + 1, dtype=jnp.int32),
                seq_lens=jnp.asarray(pos + 1), block_tables=jnp.asarray(bt),
                num_reqs=jnp.asarray(R, jnp.int32),
                num_tokens=jnp.asarray(R, jnp.int32), decode_mode=True)
    jh, jcache = jmodel.apply(params, jnp.asarray(toks), jcache, jmd)
    tmd = AttentionMetadata(
        token_req_idx=torch.arange(R, dtype=torch.int32), token_pos=t(pos),
        slot_mapping=t(dslots.astype(np.int64)), seq_lens=t(pos + 1),
        block_tables=t(bt), decode_mode=True)
    with torch.inference_mode():
        tl = tmodel.compute_logits(tmodel(t(toks.astype(np.int64)), tcache,
                                          tmd))
    jl = jmodel.compute_logits(params, jh)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache), rtol=0,
                               atol=1e-5)
    # The logits are not those of a model that repeats its input.
    assert (tl.argmax(-1).numpy() != toks).any()


def test_model_knobs_match(models):
    jmodel, params, tmodel = models
    assert tmodel.scale == jmodel.scale
    assert tmodel.attn_soft_cap == jmodel.attn_soft_cap
    assert tmodel.final_soft_cap == jmodel.final_soft_cap
    assert not tmodel.supports_window_decode
    assert not jmodel.supports_window_decode
    if "is_sliding" in params["layers"]:
        assert tmodel.is_sliding == [
            bool(x) for x in np.asarray(params["layers"]["is_sliding"])]
    else:
        assert tmodel.is_sliding is None
    np.testing.assert_array_equal(tmodel.inv_freq.numpy(),
                                  np.asarray(jmodel._inv_freq))
    local = getattr(jmodel, "_inv_freq_local", None)
    if local is None:
        assert tmodel.inv_freq_local is None
    else:
        np.testing.assert_array_equal(tmodel.inv_freq_local.numpy(),
                                      np.asarray(local))


@pytest.mark.parametrize("factor", [1.0, 4.0, 8.0])
def test_linear_inv_freq_bit_exact(factor):
    scaling = {"rope_type": "linear", "factor": factor}
    want, mscale = jax_rotary.compute_inv_freq(jax_rotary.RopeConfig(
        head_dim=256, rotary_dim=256, base=1e6, scaling=scaling))
    got = rotary.compute_inv_freq(rotary.RopeConfig(
        head_dim=256, rotary_dim=256, base=1e6, scaling=scaling))
    assert mscale == 1.0 and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_gemma_even_layers_slide_without_layer_types():
    hf = gemma_config("Gemma2ForCausalLM", layers=5)
    hf.layer_types = None
    m = create_model(ModelConfig(model="dummy", hf_config=hf,
                                 dtype="float32"), "cpu")
    assert m.is_sliding == [True, False, True, False, True]
    with pytest.raises(NotImplementedError):
        from aphrodite_tpu_torch.quantization.base import QuantizationConfig
        create_model(ModelConfig(model="dummy", hf_config=hf,
                                 dtype="float32"), "cpu",
                     QuantizationConfig(method="gptq", weight_bits=4,
                                        group_size=128))
