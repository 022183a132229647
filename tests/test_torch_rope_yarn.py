"""The port's YaRN and DeepSeek-YaRN rope and its pair-interleaved rope vs
the JAX package's ``layers/rotary.py``: inv_freq and the cos/sin magnitude
(mscale) equal bit for bit; cos/sin within 2e-6 (fp32 argument rounding,
as ``tests/test_torch_layers.py``), the interleaved rotation within 1e-6.
``dynamic`` and ``longrope`` still raise (MiniCPM3 is the first model to
need longrope)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.layers import rotary as jrotary
from aphrodite_tpu_torch.layers import rotary as trotary

V2_LITE = {"type": "yarn", "factor": 40, "original_max_position_embeddings":
           4096, "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
           "mscale_all_dim": 0.707}
SCALINGS = {
    # DeepSeek-V2-Lite's config.json, as the DeepSeek model reads it
    "deepseek_yarn-v2-lite": ({**V2_LITE, "rope_type": "deepseek_yarn"},
                              64, 10000.0, 163840),
    # mscale != mscale_all_dim: a magnitude other than 1
    "deepseek_yarn-mscale-1": ({**V2_LITE, "rope_type": "deepseek_yarn",
                                "mscale": 1.0}, 64, 10000.0, 163840),
    "deepseek_yarn-no-orig": ({"rope_type": "deepseek_yarn", "factor": 4.0,
                               "mscale_all_dim": 1.0}, 8, 10000.0, 512),
    "yarn-qwen": ({"rope_type": "yarn", "factor": 4.0,
                   "original_max_position_embeddings": 32768}, 128,
                  1000000.0, 131072),
    "yarn-attn-factor": ({"type": "yarn", "factor": 8.0, "attn_factor": 0.9,
                          "beta_fast": 16, "beta_slow": 2}, 64, 500000.0,
                         4096),
    "yarn-factor-1": ({"rope_type": "yarn", "factor": 1.0}, 32, 10000.0,
                      2048),
}


def _configs(name):
    scaling, dim, base, max_pos = SCALINGS[name]
    return (jrotary.RopeConfig(head_dim=dim, rotary_dim=dim, base=base,
                               max_position=max_pos, scaling=scaling),
            trotary.RopeConfig(head_dim=dim, rotary_dim=dim, base=base,
                               scaling=scaling, max_position=max_pos))


@pytest.mark.parametrize("name", sorted(SCALINGS))
def test_inv_freq_and_mscale_bit_exact(name):
    cfg_j, cfg_t = _configs(name)
    inv_j, ms_j = jrotary.compute_inv_freq(cfg_j)
    inv_t, ms_t = trotary.compute_inv_freq(cfg_t, with_mscale=True)
    assert inv_t.dtype == inv_j.dtype == np.float32
    np.testing.assert_array_equal(inv_t, inv_j)
    assert ms_t == ms_j and isinstance(ms_t, float)
    if ms_t != 1.0:  # the plain call refuses to drop the magnitude
        with pytest.raises(NotImplementedError, match="with_mscale"):
            trotary.compute_inv_freq(cfg_t)
    else:
        np.testing.assert_array_equal(trotary.compute_inv_freq(cfg_t),
                                      inv_j)
    pos = np.array([0, 1, 5, 63, 499, 4095, 9000], np.int32)
    cos_j, sin_j = jrotary.compute_cos_sin(jnp.asarray(pos),
                                           jnp.asarray(inv_j), ms_j)
    cos_t, sin_t = trotary.compute_cos_sin(torch.from_numpy(pos),
                                           torch.from_numpy(inv_t), ms_t)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=2e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=2e-6)


@pytest.mark.parametrize("scale,mscale", [(40.0, 0.707), (1.0, 0.707),
                                          (0.5, 1.0), (8.0, 0.0)])
def test_deepseek_yarn_mscale_bit_exact(scale, mscale):
    assert trotary.deepseek_yarn_mscale(scale, mscale) == \
        jrotary.deepseek_yarn_mscale(scale, mscale)


@pytest.mark.parametrize("rot,heads", [(64, 16), (8, 1)])
def test_apply_rope_interleaved(rot, heads):
    rng = np.random.RandomState(0)
    pos = np.array([0, 3, 17, 511], np.int32)
    inv, ms = jrotary.compute_inv_freq(jrotary.RopeConfig(
        head_dim=rot, rotary_dim=rot, max_position=163840,
        scaling={**V2_LITE, "rope_type": "deepseek_yarn"}))
    cos, sin = jrotary.compute_cos_sin(jnp.asarray(pos), jnp.asarray(inv), ms)
    x = rng.randn(len(pos), heads, rot).astype(np.float32)
    want = jrotary.apply_rope_interleaved(jnp.asarray(x), cos, sin)
    cos_t, sin_t = (torch.from_numpy(np.array(a)) for a in (cos, sin))
    got = trotary.apply_rope_interleaved(torch.from_numpy(x), cos_t, sin_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # pairs (2i, 2i+1) rotate together: not the rotate-half convention
    half = trotary.apply_rope(torch.from_numpy(x), cos_t, sin_t)
    assert not torch.allclose(got[1:], half[1:])


@pytest.mark.parametrize("scaling", [
    {"rope_type": "dynamic", "factor": 2.0},
    {"rope_type": "longrope", "short_factor": [1.0] * 4,
     "long_factor": [2.0] * 4, "original_max_position_embeddings": 64}])
def test_dynamic_and_longrope_still_raise(scaling):
    cfg = trotary.RopeConfig(head_dim=8, rotary_dim=8, scaling=scaling)
    for kw in ({}, {"with_mscale": True}):
        with pytest.raises(NotImplementedError, match="not ported"):
            trotary.compute_inv_freq(cfg, **kw)
