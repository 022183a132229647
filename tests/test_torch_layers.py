"""PyTorch port's layers vs the JAX package's functions on the same numpy
inputs. Tolerance: fp32, atol/rtol 1e-6 (elementwise math; only the
rsqrt/cos/sin implementations differ between the frameworks)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.layers import common as jcommon
from aphrodite_tpu.layers import rotary as jrotary
from aphrodite_tpu_torch.layers import common as tcommon
from aphrodite_tpu_torch.layers import rotary as trotary

TOL = dict(rtol=1e-6, atol=1e-6)


def _rng(seed=0):
    return np.random.RandomState(seed)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    rng = _rng()
    x = rng.randn(7, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    ref = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, offset)
    got = tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6,
                           offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_rms_norm_keeps_bf16():
    x = torch.from_numpy(_rng(1).randn(3, 32).astype(np.float32))
    out = tcommon.rms_norm(x.bfloat16(), torch.ones(32))
    assert out.dtype == torch.bfloat16


def test_silu_and_mul():
    rng = _rng(2)
    g = rng.randn(5, 48).astype(np.float32)
    u = rng.randn(5, 48).astype(np.float32)
    ref = jcommon.silu_and_mul(jnp.asarray(g), jnp.asarray(u))
    got = tcommon.silu_and_mul(torch.from_numpy(g), torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("head_dim,partial,base", [
    (64, 1.0, 10000.0), (128, 1.0, 1000000.0), (64, 0.5, 10000.0)])
def test_inv_freq_cos_sin_and_rope(head_dim, partial, base):
    cfg_j = jrotary.RopeConfig(head_dim=head_dim,
                               rotary_dim=int(head_dim * partial), base=base)
    cfg_t = trotary.RopeConfig(head_dim=head_dim,
                               rotary_dim=int(head_dim * partial), base=base)
    inv_j, ms_j = jrotary.compute_inv_freq(cfg_j)
    inv_t = trotary.compute_inv_freq(cfg_t)
    np.testing.assert_array_equal(inv_t, inv_j)
    assert ms_j == 1.0  # the JAX mscale the port leaves out
    pos = np.array([0, 1, 5, 63, 499, 1023], np.int32)
    cos_j, sin_j = jrotary.compute_cos_sin(jnp.asarray(pos),
                                           jnp.asarray(inv_j))
    cos_t, sin_t = trotary.compute_cos_sin(torch.from_numpy(pos),
                                           torch.from_numpy(inv_t))
    # cos/sin of arguments up to ~1e3: fp32 argument rounding dominates.
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=2e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=2e-6)
    x = _rng(3).randn(len(pos), 4, head_dim).astype(np.float32)
    ref = jrotary.apply_rope(jnp.asarray(x), cos_j, sin_j)
    got = trotary.apply_rope(torch.from_numpy(x), cos_t, sin_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_rope_scaling_is_not_ported():
    # llama3 is ported (tests/test_torch_quant.py); yarn is not yet.
    cfg = trotary.RopeConfig(head_dim=64, rotary_dim=64,
                             scaling={"rope_type": "yarn", "factor": 8.0})
    with pytest.raises(NotImplementedError):
        trotary.compute_inv_freq(cfg)
