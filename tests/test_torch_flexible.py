"""The port's ``FlexibleDecoder`` families (BLOOM, MPT, Falcon in its three
generations, Baichuan with ALiBi and with rope) vs the JAX package's
``models/llama_variants.py`` on the same weights (the JAX dummy tree redrawn
from a seeded numpy generator, loaded through ``params_from_jax``) and the
same metadata: a prefill wave, then a decode-mode step (the path the
runner's multi-step decode takes, with the decode kernel's plain version on
the port's side).

The tiny geometry: 2 layers, hidden 96, vocab 256, 6 or 12 query heads (96
has no power-of-two divisor that leaves 6 or 12 heads of equal width at
64), so that ALiBi takes the slopes' interpolation branch. Two more at the
geometries the card's tensor-core instances reach in 128-wide tiles and in
row slices: a BLOOM at BLOOM-3b's head_dim 80 (hidden 240, 3 heads) and a
Falcon-7B-style multi-query model with a group past one 16-row mma tile
(18 query heads of 16 on one KV head).

Tolerance: fp32, atol 1e-4 on logits and hidden states, 1e-5 times the
largest |value| (at least 1) on the K/V written into the cache (the
frameworks order their matmul sums differently; the port fuses Q/K/V and
gate/up along N). Slopes and rope
frequencies equal the JAX ones bit for bit."""
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
from aphrodite_tpu_torch.loader.weights import (create_model, load_model,
                                                load_params, params_from_jax)
from aphrodite_tpu_torch.config import LoadConfig
from aphrodite_tpu_torch.models import llama_variants as lv

from tests.test_torch_gemma import BLOCK, _layout

H, LAYERS, VOCAB = 96, 2, 256

# family: (architecture, config fields in their config.json spelling,
# transformers class or None for a generic config (Baichuan: remote code)).
FAMILIES = {
    "bloom": ("BloomForCausalLM", "BloomConfig",
              dict(n_head=6, n_layer=LAYERS)),
    "mpt_clip": ("MPTForCausalLM", "MptConfig",
                 dict(n_heads=12, n_layers=LAYERS, d_model=H,
                      expansion_ratio=2, attn_config={
                          "clip_qkv": 0.6, "alibi_bias_max": 8})),
    "falcon_rw": ("RWForCausalLM", "FalconConfig",
                  dict(num_attention_heads=6, num_hidden_layers=LAYERS,
                       alibi=True, parallel_attn=False, multi_query=False,
                       bias=True)),
    "falcon_7b": ("FalconForCausalLM", "FalconConfig",
                  dict(num_attention_heads=6, num_hidden_layers=LAYERS,
                       alibi=False, parallel_attn=True, multi_query=True,
                       bias=False)),
    "falcon_new": ("FalconForCausalLM", "FalconConfig",
                   dict(num_attention_heads=6, num_hidden_layers=LAYERS,
                        new_decoder_architecture=True, num_kv_heads=2,
                        alibi=False, bias=False)),
    "baichuan_alibi": ("BaichuanForCausalLM", None,
                       dict(num_attention_heads=12,
                            num_hidden_layers=LAYERS,
                            intermediate_size=128, rms_norm_eps=1e-6,
                            hidden_act="silu", tie_word_embeddings=False,
                            model_max_length=512)),
    "bloom_hd80": ("BloomForCausalLM", "BloomConfig",
                   dict(n_head=3, n_layer=LAYERS, hidden_size=240)),
    "falcon_7b_group18": ("FalconForCausalLM", "FalconConfig",
                          dict(num_attention_heads=18,
                               num_hidden_layers=LAYERS, hidden_size=288,
                               alibi=False, parallel_attn=True,
                               multi_query=True, bias=False)),
    "baichuan_rope": ("BaiChuanForCausalLM", None,
                      dict(num_attention_heads=6, num_hidden_layers=LAYERS,
                           intermediate_size=128, rms_norm_eps=1e-6,
                           hidden_act="silu", tie_word_embeddings=False,
                           model_max_length=512)),
}
ALIBI = ("bloom", "mpt_clip", "falcon_rw", "baichuan_alibi", "bloom_hd80")
# The families held at their logits only (their geometry is what they add:
# tests/test_torch_flexible_llm.py serves the others end to end).
LOGITS_ONLY = ("bloom_hd80", "falcon_7b_group18")
MODEL_TYPES = {"BloomConfig": "bloom", "MptConfig": "mpt",
               "FalconConfig": "falcon"}


def family_dict(name):
    """The family's config as a plain dict in its config.json spelling
    (what the port reads without ``transformers``)."""
    arch, cls, fields = FAMILIES[name]
    d = dict(architectures=[arch], vocab_size=VOCAB, **fields)
    if "d_model" not in d and "hidden_size" not in d:
        d["hidden_size"] = H
    if cls is not None:
        d["model_type"] = MODEL_TYPES[cls]
    return d


def family_config(name):
    """The family's config as ``transformers`` builds it (a generic
    ``PretrainedConfig`` for Baichuan, which needs remote code)."""
    import transformers as tf
    arch, cls, fields = FAMILIES[name]
    d = {k: v for k, v in family_dict(name).items() if k != "model_type"}
    return (tf.PretrainedConfig(**d) if cls is None
            else getattr(tf, cls)(**d))


def perturb(tree, seed):
    """The JAX dummy tree redrawn from a seeded numpy generator: the
    embedding at 1/sqrt(H) (tied heads then give logits of order one),
    projections at 3x fan-in scale (at fan-in scale the embedding's own
    direction dominates the residual and a tied head repeats the input
    token), norm scales near 1 and biases near 0, so that every leaf moves
    the logits. Leaves stay float32 numpy arrays."""
    rng = np.random.RandomState(seed)

    def draw(name, v):
        shape = tuple(v.shape)
        if name.endswith("_b") or name.startswith("b"):
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        if "ln" in name or "norm" in name:
            return (1 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "embed":
            return (rng.randn(*shape) / np.sqrt(shape[-1])).astype(
                np.float32)
        return (3 * rng.randn(*shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    out = {k: draw(k, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: draw(k, v) for k, v in tree["layers"].items()}
    return out


def _close_kv(tcache, jcache):
    """K/V within 1e-5 of the largest |value| in the reference cache."""
    ref = np.asarray(jcache)
    np.testing.assert_allclose(tcache.numpy(), ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))


def jax_model(hf):
    return jax_create_model(JaxModelConfig(
        model="dummy", hf_config=hf, tokenizer="unused", dtype="float32"))


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def models(request):
    hf = family_config(request.param)
    jmodel = jax_model(hf)
    # The dummy tree's shapes only (no draw): perturb redraws every leaf.
    params = perturb(jax.eval_shape(jmodel.init_dummy_params,
                                    jax.random.PRNGKey(0)), 3)
    tmodel = create_model(ModelConfig(model="dummy", hf_config=hf,
                                      dtype="float32"), "cpu")
    load_params(tmodel, params_from_jax(params))
    return request.param, jmodel, jax.tree.map(jnp.asarray, params), tmodel


def test_prefill_then_decode_mode_logits_match(models):
    name, jmodel, params, tmodel = models
    rng = np.random.RandomState(0)
    lens = [40, 23, 7, 18]
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
        tl = tmodel.compute_logits(th[t(qsl[1:].astype(np.int64) - 1)])
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-4)
    jl = jmodel.compute_logits(params, jh[jnp.asarray(qsl[1:] - 1)])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    _close_kv(tcache, jcache)

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
    _close_kv(tcache, jcache)
    # The logits are not those of a model that repeats its input.
    assert (tl.argmax(-1).numpy() != toks).any()


def test_model_knobs_match(models):
    name, jmodel, params, tmodel = models
    assert tmodel.positions == jmodel.positions
    assert (tmodel.positions == "alibi") == (name in ALIBI)
    for knob in ("scale", "norm_kind", "norm_bias", "norm_eps",
                 "parallel_residual", "shared_ln", "embed_norm",
                 "attn_bias", "attn_out_bias", "clip_qkv", "mlp_kind",
                 "mlp_bias", "tie_embeddings", "intermediate_size",
                 "num_kv_heads", "head_dim", "final_norm"):
        assert getattr(tmodel, knob) == getattr(jmodel, knob), knob
    assert not tmodel.supports_window_decode
    assert not getattr(jmodel, "supports_window_decode", False)
    if tmodel.positions == "alibi":
        want = np.asarray(jmodel._alibi)
        assert want.dtype == np.float32
        np.testing.assert_array_equal(tmodel.alibi.numpy().view(np.uint32),
                                      want.view(np.uint32))
        assert tmodel.inv_freq is None
    else:
        assert tmodel.alibi is None
        np.testing.assert_array_equal(tmodel.inv_freq.numpy(),
                                      np.asarray(jmodel._inv_freq))
    if name == "mpt_clip":
        assert tmodel.clip_qkv == 0.6


def test_mpt_kv_n_heads_is_not_read():
    """An MPT config that sets ``attn_config.kv_n_heads`` (llm-foundry's
    grouped-query MPT): the reference reads that field for DBRX only, so it
    builds one KV head a query head (``aphrodite_tpu/config.py:236-245``),
    and so does the port (ROADMAP C: fixed). The geometry
    and a prefill wave's logits match the JAX model's."""
    import transformers as tf
    fields = dict(FAMILIES["mpt_clip"][2])
    fields["attn_config"] = dict(fields["attn_config"], kv_n_heads=2)
    d = dict(architectures=["MPTForCausalLM"], vocab_size=VOCAB, **fields)
    hf = tf.MptConfig(**d)
    jmodel = jax_model(hf)
    assert jmodel.num_kv_heads == 12
    for cfg in (hf, dict(d, model_type="mpt")):
        assert ModelConfig(model="dummy", hf_config=cfg).num_kv_heads == 12
    tmodel = create_model(ModelConfig(model="dummy", hf_config=hf,
                                      dtype="float32"), "cpu")
    assert tmodel.num_kv_heads == 12
    params = perturb(jax.eval_shape(jmodel.init_dummy_params,
                                    jax.random.PRNGKey(0)), 5)
    load_params(tmodel, params_from_jax(params))
    params = jax.tree.map(jnp.asarray, params)
    rng = np.random.RandomState(1)
    lens = [30, 9]
    bt, slot, num_pages = _layout(lens)
    tok_req = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    tok_pos = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    slots = np.asarray([slot(r, q) for r, q in zip(tok_req, tok_pos)],
                       np.int32)
    ids = rng.randint(1, 250, size=sum(lens)).astype(np.int32)
    sl = np.asarray(lens, np.int32)
    qsl = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    jcache = jnp.zeros((LAYERS, num_pages, 2, 12, BLOCK, H // 12),
                       jnp.float32)
    jh, _ = jmodel.apply(params, jnp.asarray(ids), jcache, JaxMD(
        token_req_idx=jnp.asarray(tok_req), token_pos=jnp.asarray(tok_pos),
        slot_mapping=jnp.asarray(slots), query_start_loc=jnp.asarray(qsl),
        seq_lens=jnp.asarray(sl), block_tables=jnp.asarray(bt),
        num_reqs=jnp.asarray(len(lens), jnp.int32),
        num_tokens=jnp.asarray(len(ids), jnp.int32)))
    t = torch.from_numpy
    last = qsl[1:].astype(np.int64) - 1
    with torch.inference_mode():
        th = tmodel(t(ids.astype(np.int64)), torch.zeros(tuple(jcache.shape)),
                    AttentionMetadata(
                        token_req_idx=t(tok_req), token_pos=t(tok_pos),
                        slot_mapping=t(slots.astype(np.int64)),
                        seq_lens=t(sl), block_tables=t(bt)))
        tl = tmodel.compute_logits(th[t(last)])
    jl = jmodel.compute_logits(params, jh[jnp.asarray(last)])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_dict_config_spelling_gives_the_same_model(name):
    """The config.json spelling (``n_head``, ``d_model``, ``model_max_length``,
    Falcon's and MPT's KV-head fields) read as a plain dict gives the
    geometry the ``transformers`` config gives."""
    a = ModelConfig(model="dummy", hf_config=family_dict(name))
    b = ModelConfig(model="dummy", hf_config=family_config(name))
    for prop in ("hidden_size", "num_layers", "num_attention_heads",
                 "num_kv_heads", "head_dim", "vocab_size", "architecture"):
        assert getattr(a, prop) == getattr(b, prop), prop
    if name.startswith("baichuan"):
        assert a.max_model_len == 512   # from model_max_length


def test_dummy_init_follows_the_recipe():
    model = load_model(ModelConfig(model="dummy", dtype="float32",
                                   hf_config=family_dict("bloom")),
                       LoadConfig(), "cpu")
    state = model.state_dict()
    for key in ("layers.0.ln1_w", "layers.1.ln2_w", "embed_ln_w",
                "final_norm_w"):
        assert torch.equal(state[key], torch.ones_like(state[key])), key
    for key in ("layers.0.ln1_b", "layers.0.b_qkv", "layers.1.bo",
                "layers.0.fc1_b", "layers.1.fc2_b", "embed_ln_b",
                "final_norm_b"):
        assert not state[key].any(), key
    w = state["layers.0.w_qkv"]
    assert 0.015 < float(w.std()) < 0.025
    assert "lm_head" not in state   # tied


class _Knob(lv.BaichuanForCausalLM):
    knob: dict = {}

    def _setup(self, config):
        super()._setup(config)
        for k, v in self.knob.items():
            setattr(self, k, v)


UNPORTED_KNOBS = {
    "qk_norm": "per_head_rms", "sandwich_norm": True, "block_norm": "post",
    "norm_kind": "ln1p", "positions": "learned", "rope_interleaved": True,
    "blocksparse": (64, 1, 8, 0), "sliding_flags": [1, 0],
    "mlp_kind": "moe", "attn_soft_cap": 30.0, "lm_head_bias": True,
    "logits_multiplier": 0.5, "residual_multiplier": 0.5,
}


@pytest.mark.parametrize("knob", sorted(UNPORTED_KNOBS))
def test_unported_knobs_raise(knob):
    cls = type("K", (_Knob,), {"knob": {knob: UNPORTED_KNOBS[knob]}})
    with pytest.raises(NotImplementedError, match="A13"):
        cls(ModelConfig(model="dummy", dtype="float32",
                        hf_config=family_dict("baichuan_alibi")))


def test_partial_rope_quantization_and_unknown_leaves_raise():
    d = dict(family_dict("falcon_7b"), partial_rotary_factor=0.5)
    with pytest.raises(NotImplementedError, match="partial rotary"):
        create_model(ModelConfig(model="dummy", hf_config=d), "cpu")
    from aphrodite_tpu_torch.quantization.base import QuantizationConfig
    with pytest.raises(NotImplementedError, match="quantized"):
        lv.BloomForCausalLM(ModelConfig(model="dummy",
                                        hf_config=family_dict("bloom")),
                            quant_config=QuantizationConfig("gptq", 4, 128))
    tree = {"embed": np.zeros((4, 2)), "layers": {
        "ln1_w": np.zeros((1, 2)), "q_norm": np.zeros((1, 2))}}
    with pytest.raises(NotImplementedError, match="q_norm"):
        params_from_jax(tree)
