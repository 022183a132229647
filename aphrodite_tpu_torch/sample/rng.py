"""The sampler's random stream: threefry2x32, as ``jax.random`` draws it.

The JAX sampler derives every row's noise in-graph from its seed and output
position (``aphrodite_tpu/sample/sampler.py:402-409``)::

    key        = fold_in(PRNGKey(seed), out_len + step_offset)
    key_xtc    = fold_in(key, 1)     # XTC's scalar uniform
    key_sample = fold_in(key, 2)     # the Gumbel noise over the vocabulary

This module rebuilds that stream from threefry2x32 alone, on int64 tensors
whose values stay in [0, 2**32) (each sum masked), vectorised over rows: a
key is a pair of [R] tensors ``(k0, k1)``. With ``jax_threefry_partitionable``
(the default) the rules are:

- ``PRNGKey(s)`` for a 31-bit seed is ``(0, s)``;
- ``fold_in(k, d)`` is ``threefry(k, (0, d))``;
- ``random_bits(k, n)[i]`` is ``x0 ^ x1`` of ``threefry(k, (0, i))``;
- ``uniform`` puts the top 23 bits under the exponent of 1.0, subtracts 1
  and scales to ``[minval, maxval)``, then ``max(minval, .)``;
- ``gumbel`` is ``-log(-log(uniform(minval=tiny)))``.

Bits and uniforms equal ``jax.random``'s bit for bit; the Gumbel values
differ by the last ulp of the logs (``tests/test_torch_rng.py``). These are
the plain versions: the CPU and the tests use them, and the Gumbel-max
kernel (``ops/gumbel_sample.py``) draws the same bits in registers.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32's smallest normal number, gumbel's minval.
TINY = float(torch.finfo(torch.float32).tiny)

Key = tuple[torch.Tensor, torch.Tensor]


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor) -> Key:
    """The 20-round threefry2x32 block of (x0, x1) under ``key``; every
    tensor int64 in [0, 2**32), broadcast together."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed: torch.Tensor) -> Key:
    """``jax.random.PRNGKey`` of non-negative int32 seeds [R]."""
    seed = seed.to(torch.int64) & MASK32
    return torch.zeros_like(seed), seed


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in`` of each row's key with ``data`` (an int or
    an [R] tensor of non-negative values below 2**31)."""
    k0 = key[0]
    # A fill, not a copy from the host: no wait on the device's queue.
    d = (data.to(torch.int64) if isinstance(data, torch.Tensor)
         else torch.full_like(k0, data))
    return threefry2x32(key, torch.zeros_like(k0), d.expand_as(k0))


def random_bits(key: Key, n: int) -> torch.Tensor:
    """``jax.random.bits(k, (n,), uint32)`` of each row's key: [R, n] int64
    in [0, 2**32)."""
    k0, k1 = key
    lo = torch.arange(n, dtype=torch.int64, device=k0.device)[None, :]
    y0, y1 = threefry2x32((k0[:, None], k1[:, None]), torch.zeros_like(lo),
                          lo)
    return y0 ^ y1


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """Uniform float32 in [0, 1) from 32-bit values: the top 23 bits as
    the mantissa of a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: Key, shape: tuple = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (float32) of each row's key: [R, *shape]."""
    n = 1
    for d in shape:
        n *= d
    f = bits_to_unit(random_bits(key, n))
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    out = torch.maximum(f * span + lo, lo)
    return out.reshape(key[0].shape[0], *shape)


def gumbel(key: Key, shape: tuple) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, mode "low") of each row's key."""
    return -torch.log(-torch.log(uniform(key, shape, minval=TINY)))


def sample_keys(seeds: torch.Tensor, counters: torch.Tensor
                ) -> tuple[Key, Key]:
    """(key_xtc, key_sample) of ``sample_tokens``: fold the row's counter
    (out_len + step_offset) into its seed's key, then 1 for XTC and 2 for
    the sample."""
    key = fold_in(prng_key(seeds), counters)
    return fold_in(key, 1), fold_in(key, 2)
