"""The port's threefry stream (``aphrodite_tpu_torch/sample/rng.py``) vs
``jax.random`` (threefry2x32, ``jax_threefry_partitionable``).

Keys, bits and uniforms must be equal bit for bit, over many seeds,
counters and vocabulary sizes (odd ones too), and the scalar XTC draw. The
Gumbel values differ only through the last ulp of the two logs:
|port - jax| <= GUMBEL_ULPS * ulp(max(1, |g|)) (observed at most one ulp
of the result, 4.8e-7 at |g| < 4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu_torch.sample import rng

GUMBEL_ULPS = 4
SEEDS = np.array([0, 1, 2, 7919, 12345, 2**31 - 1, 99991, 31337],
                 np.uint32)


def _jax_keys(seeds, counters):
    keys = jax.vmap(lambda s, c: jax.random.fold_in(
        jax.random.PRNGKey(s.astype(jnp.int32)), c))(seeds, counters)
    return (keys, jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys),
            jax.vmap(lambda k: jax.random.fold_in(k, 2))(keys))


def _port_keys(seeds, counters):
    return rng.sample_keys(torch.from_numpy(seeds.astype(np.int64)),
                           torch.from_numpy(counters))


def _as_np(key):
    return torch.stack(key, 1).numpy()


@pytest.mark.parametrize("counter_base", [0, 1, 63, 4096, 2**30])
def test_keys_equal(counter_base):
    counters = (counter_base + np.arange(len(SEEDS))).astype(np.int32)
    keys, kx, ks = _jax_keys(SEEDS, counters)
    px, ps = _port_keys(SEEDS, counters)
    np.testing.assert_array_equal(_as_np(px), np.asarray(kx))
    np.testing.assert_array_equal(_as_np(ps), np.asarray(ks))
    base = rng.fold_in(rng.prng_key(torch.from_numpy(
        SEEDS.astype(np.int64))), torch.from_numpy(counters))
    np.testing.assert_array_equal(_as_np(base), np.asarray(keys))


@pytest.mark.parametrize("V", [1, 7, 128, 1000, 4099])
def test_bits_and_uniforms_equal(V):
    counters = np.arange(len(SEEDS), dtype=np.int32) * 3
    _, _, ks = _jax_keys(SEEDS, counters)
    _, ps = _port_keys(SEEDS, counters)
    bits = jax.vmap(lambda k: jax.random.bits(k, (V,)))(ks)
    np.testing.assert_array_equal(rng.random_bits(ps, V).numpy(),
                                  np.asarray(bits).astype(np.int64))
    tiny = np.finfo(np.float32).tiny
    for lo in (0.0, float(tiny)):
        u = jax.vmap(lambda k: jax.random.uniform(k, (V,), minval=lo))(ks)
        np.testing.assert_array_equal(
            rng.uniform(ps, (V,), minval=lo).numpy(), np.asarray(u))


@pytest.mark.parametrize("V", [7, 1000, 4099])
def test_gumbel_within_ulps(V):
    counters = np.arange(len(SEEDS), dtype=np.int32) + 11
    _, _, ks = _jax_keys(SEEDS, counters)
    _, ps = _port_keys(SEEDS, counters)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(ks))
    got = rng.gumbel(ps, (V,)).numpy()
    ulp = np.spacing(np.maximum(1.0, np.abs(want)).astype(np.float32))
    assert np.all(np.abs(got - want) <= GUMBEL_ULPS * ulp)


def test_scalar_xtc_uniform_equal():
    counters = np.arange(len(SEEDS), dtype=np.int32) * 5
    _, kx, _ = _jax_keys(SEEDS, counters)
    px, _ = _port_keys(SEEDS, counters)
    want = jax.vmap(lambda k: jax.random.uniform(k, ()))(kx)
    got = rng.uniform(px)
    assert got.shape == (len(SEEDS),)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_threefry_known_answer():
    """The Random123 known-answer vector for threefry2x32 (20 rounds):
    key (0x13198a2e, 0x03707344), counter (0x243f6a88, 0x85a308d3)."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    x0, x1 = rng.threefry2x32((t(0x13198a2e), t(0x03707344)),
                              t(0x243f6a88), t(0x85a308d3))
    assert (int(x0), int(x1)) == (0xc4923a9c, 0x483df7a0)
