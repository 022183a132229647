"""The port's vision path vs the JAX package's on the same weights and
inputs: the SigLIP tower, Gemma-3's pooled projector and PaliGemma's
linear one, a prefill wave with image rows scattered and (Gemma-3) image
spans in the metadata, the adapters (placeholders expanded one an image or
given pre-expanded; HWC uint8 / float, CHW and NCHW pixels), the content
hash, the encoder cache and the nested text config.

Weights: the JAX dummy tree redrawn at fan-in scale (``perturb_mm``; the
text part as ``test_torch_gemma.perturb`` does), carried over by
``params_from_jax``. Tolerance: fp32, atol 1e-5 on the tower's features and
the image rows, 1e-4 on hidden states and logits (3 text layers; the
frameworks order their sums differently)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu import multimodal as jax_mm
from aphrodite_tpu.attention.metadata import AttentionMetadata as JaxMD
from aphrodite_tpu.config import ModelConfig as JaxModelConfig
from aphrodite_tpu.loader.weights import create_model as jax_create_model
from aphrodite_tpu.worker.encoder_cache import EncoderCache as JaxCache
from aphrodite_tpu_torch import multimodal
from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.config import ModelConfig
from aphrodite_tpu_torch.loader.weights import (create_model, load_params,
                                                params_from_jax)
from aphrodite_tpu_torch.worker.encoder_cache import EncoderCache

from tests.test_torch_gemma import perturb

IMG, BOI, EOI = 255, 253, 254
ARCHS = ["gemma3", "paligemma", "paligemma2"]
BLOCK = 16


def mm_config(arch: str, text_layers: int = 3):
    """A tiny config of each family (transformers' classes, as the JAX
    package reads them): a 2-layer SigLIP tower of width 32 on 16 x 16
    images; Gemma-3 over its text decoder (8-token sliding window, two
    sliding layers then a global one, 4 image tokens pooled from 4 x 4
    patches), PaliGemma over Gemma or Gemma-2 (4 image tokens, 8 x 8
    patches)."""
    import transformers as tf
    vision = tf.SiglipVisionConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, image_size=16,
        patch_size=4 if arch == "gemma3" else 8)
    common = dict(vocab_size=256, hidden_size=64,
                  num_hidden_layers=text_layers, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16,
                  intermediate_size=128, max_position_embeddings=512)
    if arch == "gemma3":
        text = tf.Gemma3TextConfig(
            query_pre_attn_scalar=16, sliding_window=8,
            layer_types=(["sliding_attention"] * (text_layers - 1)
                         + ["full_attention"]),
            rope_theta=1e6, rope_local_base_freq=1e4,
            rope_scaling={"rope_type": "linear", "factor": 8.0}, **common)
        return tf.Gemma3Config(
            text_config=text.to_dict(), vision_config=vision.to_dict(),
            image_token_index=IMG, mm_tokens_per_image=4,
            boi_token_index=BOI, eoi_token_index=EOI,
            architectures=["Gemma3ForConditionalGeneration"])
    text = (tf.Gemma2Config(sliding_window=8, query_pre_attn_scalar=24,
                            **common)
            if arch == "paligemma2" else tf.GemmaConfig(**common))
    return tf.PaliGemmaConfig(
        vision_config=vision.to_dict(), text_config=text.to_dict(),
        image_token_index=IMG, projection_dim=64,
        architectures=["PaliGemmaForConditionalGeneration"])


def perturb_mm(tree, seed):
    """``perturb`` for the text part; the tower and the projector drawn
    from a seeded numpy generator: LayerNorm weights near 1, biases and
    positions small, weights [.., fan_in, fan_out] at fan-in scale, the
    Gemma-3 projector's norm (stored as w - 1) near 0."""
    out = perturb(tree, seed)
    rng = np.random.RandomState(seed + 1)

    def draw(name, v):
        shape = np.asarray(v).shape
        if name.startswith("ln") or name.endswith("ln_w"):
            if name.endswith("_w"):
                return (1 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if len(shape) == 1 or name.startswith("b") or name.endswith("_b") \
                or name in ("pos", "soft_emb_norm"):
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        return (rng.randn(*shape) / np.sqrt(shape[-2])).astype(np.float32)

    vision = {k: draw(k, v) for k, v in tree["vision"].items()
              if k != "layers"}
    vision["layers"] = {k: draw(k, v)
                        for k, v in tree["vision"]["layers"].items()}
    out["vision"] = vision
    out["projector"] = {k: draw(k, v) for k, v in tree["projector"].items()}
    return out


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    hf = mm_config(request.param)
    jmodel = jax_create_model(JaxModelConfig(
        model="dummy", hf_config=hf, tokenizer="unused", dtype="float32"))
    params = perturb_mm(jmodel.init_dummy_params(jax.random.PRNGKey(0)), 3)
    tmodel = create_model(ModelConfig(model="dummy", hf_config=hf,
                                      dtype="float32"), "cpu")
    load_params(tmodel, params_from_jax(params))
    return request.param, jmodel, jax.tree.map(jnp.asarray, params), tmodel


def _pixels(n, seed=0):
    return np.random.RandomState(seed).randn(n, 3, 16, 16).astype(np.float32)


def test_tower_and_projector_match(models):
    _, jmodel, params, tmodel = models
    pv = _pixels(3)
    with torch.inference_mode():
        feats = tmodel.vision(torch.from_numpy(pv))
        rows = tmodel.encode_images(torch.from_numpy(pv))
    want = jmodel.vision.encode(params["vision"], jnp.asarray(pv))
    np.testing.assert_allclose(feats.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    want = jmodel.encode_images(params, jnp.asarray(pv))
    assert rows.shape == (3 * 4, 64)
    np.testing.assert_allclose(rows.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    # Each image gives its own rows.
    assert np.abs(rows[:4].numpy() - rows[4:8].numpy()).max() > 1e-3
    assert tmodel.is_multimodal
    assert (getattr(tmodel, "needs_bidir_mm", False)
            == getattr(jmodel, "needs_bidir_mm", False))


def test_prefill_with_image_rows_matches(models):
    """One wave of two prompts, the first with two images (4 tokens each),
    its rows scattered at their placeholders, the spans in the metadata
    where the model asks for them (Gemma-3); the second text only."""
    arch, jmodel, params, tmodel = models
    rng = np.random.RandomState(1)
    ids0 = ([2, 7, BOI] + [IMG] * 4 + [EOI, 9, BOI] + [IMG] * 4 + [EOI]
            + rng.randint(10, 250, size=6).tolist())
    ids1 = rng.randint(10, 250, size=11).tolist()
    lens = [len(ids0), len(ids1)]
    spans = [[(3, 7), (10, 14)], []]
    pv = _pixels(2, seed=2)
    pages = [-(-n // BLOCK) for n in lens]
    bt = np.zeros((2, max(pages)), np.int32)
    bt[0, :pages[0]] = np.arange(1, 1 + pages[0])
    bt[1, :pages[1]] = np.arange(1 + pages[0], 1 + sum(pages))
    tok_req = np.repeat(np.arange(2), lens).astype(np.int32)
    tok_pos = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    slots = (bt[tok_req, tok_pos // BLOCK] * BLOCK + tok_pos % BLOCK
             ).astype(np.int32)
    ids = np.asarray(ids0 + ids1, np.int32)
    sl = np.asarray(lens, np.int32)
    idx = np.asarray([t for lo, hi in spans[0] for t in range(lo, hi)],
                     np.int32)
    span_rows = None
    if getattr(jmodel, "needs_bidir_mm", False):
        span_rows = np.full((2, 2, 2), -1, np.int32)
        span_rows[0] = [(lo, hi) for lo, hi in spans[0]]
    L, kvh, hd = jmodel.num_layers, jmodel.num_kv_heads, jmodel.head_dim
    jcache = jnp.zeros((L, 1 + sum(pages), 2, kvh, BLOCK, hd), jnp.float32)
    tcache = torch.zeros(tuple(jcache.shape))
    qsl = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    jmd = JaxMD(token_req_idx=jnp.asarray(tok_req),
                token_pos=jnp.asarray(tok_pos),
                slot_mapping=jnp.asarray(slots),
                query_start_loc=jnp.asarray(qsl), seq_lens=jnp.asarray(sl),
                block_tables=jnp.asarray(bt),
                num_reqs=jnp.asarray(2, jnp.int32),
                num_tokens=jnp.asarray(len(ids), jnp.int32),
                mm_bidir_spans=(None if span_rows is None
                                else jnp.asarray(span_rows)))
    emb = jmodel.encode_images(params, jnp.asarray(pv))
    jh, _ = jmodel.apply(params, jnp.asarray(ids), jcache, jmd,
                         mm=(emb, jnp.asarray(idx)))
    t = torch.from_numpy
    tmd = AttentionMetadata(
        token_req_idx=t(tok_req), token_pos=t(tok_pos),
        slot_mapping=t(slots.astype(np.int64)), seq_lens=t(sl),
        block_tables=t(bt),
        mm_bidir_spans=None if span_rows is None else t(span_rows))
    with torch.inference_mode():
        rows = tmodel.encode_images(t(pv))
        # A row scattered to T (past the wave) drops.
        th = tmodel(t(ids.astype(np.int64)), tcache, tmd,
                    mm=(torch.cat([rows, rows[:1]]),
                        t(np.append(idx, len(ids)).astype(np.int64))))
        kept = tmodel(t(ids.astype(np.int64)), torch.zeros_like(tcache),
                      tmd, mm=(rows, t(idx.astype(np.int64))))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-4)
    np.testing.assert_allclose(kept.numpy(), th.numpy(), rtol=0, atol=0)
    # The images reach the text rows after them.
    with torch.inference_mode():
        blind = tmodel(t(ids.astype(np.int64)), torch.zeros_like(tcache),
                       tmd)
    assert np.abs(blind[-len(ids1) - 1].numpy()
                  - th[-len(ids1) - 1].numpy()).max() > 1e-3
    np.testing.assert_allclose(blind[len(ids0):].numpy(),
                               th[len(ids0):].numpy(), rtol=0, atol=1e-6)


def _adapters(arch):
    hf = mm_config(arch)
    cls = {"gemma3": "Gemma3Adapter", "paligemma": "PaliGemmaAdapter",
           "paligemma2": "PaliGemmaAdapter"}[arch]
    return getattr(multimodal, cls)(hf), getattr(jax_mm, cls)(hf)


@pytest.mark.parametrize("arch", ARCHS)
def test_adapters_expand_prompts_as_jax(arch):
    port, ref = _adapters(arch)
    assert port.tokens_per_image == ref.tokens_per_image == 4
    for ids, n in (([2, 7, BOI, IMG, EOI, 9], 1),
                   ([2, IMG, 5, IMG, 4], 2),
                   ([2, 7] + [IMG] * 4 + [9] + [IMG] * 4 + [4], 2),  # given
                   ([IMG] * 8 + [3], 2)):                            # expanded
        assert port.expand_prompt(ids, n) == ref.expand_prompt(ids, n)
    with pytest.raises(ValueError):
        port.expand_prompt([2, IMG, 4], 2)
    with pytest.raises(ValueError):
        ref.expand_prompt([2, IMG, 4], 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_adapters_preprocess_as_jax(arch):
    port, ref = _adapters(arch)
    rng = np.random.RandomState(4)
    hwc8 = rng.randint(0, 256, size=(16, 16, 3)).astype(np.uint8)
    hwcf = rng.rand(16, 16, 3).astype(np.float32)
    chw = rng.randn(3, 16, 16).astype(np.float32)
    nchw = rng.randn(2, 3, 16, 16).astype(np.float32)
    for images in (hwc8, hwcf, chw, [hwc8, chw], nchw):
        got, want = port.preprocess(images), ref.preprocess(images)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        port.preprocess(np.zeros((8, 8, 3), np.uint8))


def test_get_mm_adapter_and_content_hash():
    for arch, cls in (("gemma3", multimodal.Gemma3Adapter),
                      ("paligemma", multimodal.PaliGemmaAdapter)):
        assert type(multimodal.get_mm_adapter(mm_config(arch))) is cls
    assert multimodal.get_mm_adapter(
        ModelConfig(model="x", hf_config=dict(
            architectures=["Gemma3ForCausalLM"])).hf_config) is None
    pv = _pixels(2)
    spans = [(3, 4), (9, 4)]
    got = multimodal.MMInputs(pixel_values=pv, spans=spans)
    want = jax_mm.MMInputs(pixel_values=pv, spans=spans)
    assert got.content_hash() == want.content_hash() == got.content_hash()
    other = multimodal.MMInputs(pixel_values=pv + 1e-3, spans=spans)
    assert other.content_hash() != got.content_hash()


def test_encoder_cache_as_jax():
    """The same puts and gets under a budget of three 64 x 64 fp32 rows
    blocks: the same hits, misses, evictions and entries."""
    port, ref = EncoderCache(budget_bytes=3 * 64 * 64 * 4), \
        JaxCache(budget_bytes=3 * 64 * 64 * 4)
    for op, key in (("put", 1), ("put", 2), ("get", 1), ("put", 3),
                    ("put", 4), ("get", 2), ("get", 1), ("get", None),
                    ("put", 5), ("get", 3), ("put", 1), ("get", 9)):
        if op == "put":
            port.put(key, torch.zeros(64, 64))
            ref.put(key, np.zeros((64, 64), np.float32))
        else:
            assert (port.get(key) is None) == (ref.get(key) is None)
    assert port.stats_dict() == ref.stats_dict()
    port.put(7, torch.zeros(128, 128))   # past the whole budget: not kept
    assert port.get(7) is None


def test_nested_dict_config_reads_the_text_config():
    """A dict config whose geometry sits in ``text_config`` (as
    config.json has it; remote-code spellings filled in there too) reads
    like the JAX ModelConfig on the transformers object."""
    hf = mm_config("gemma3")
    want = JaxModelConfig(model="dummy", hf_config=hf, tokenizer="unused")
    d = hf.to_dict()
    d["text_config"] = dict(d["text_config"])
    d["text_config"]["n_head"] = d["text_config"].pop("num_attention_heads")
    got = ModelConfig(model="dummy", hf_config=d)
    for name in ("hidden_size", "num_layers", "num_attention_heads",
                 "num_kv_heads", "head_dim", "vocab_size", "sliding_window"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.max_model_len == 512
    assert got.architecture == "Gemma3ForConditionalGeneration"
    assert got.hf_config.vision_config.patch_size == 4
    assert got.get("rope_local_base_freq") == 1e4
