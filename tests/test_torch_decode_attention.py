"""The port's decode paged attention (its plain version, which the CUDA
wrapper runs on CPU tensors) vs the JAX package's ``decode_paged_attention``
Pallas kernel in interpret mode and its ``ref_ragged_paged_attention``
oracle with decode metadata, on the same numpy inputs; and the launch
sizing of the decode kernel against an H100's shared memory. The bf16
kernel's split plan and its split-and-merge model are in
``test_torch_decode_split.py`` (two files that the Tier-1 workers
spread).

Tolerance: fp32, atol 1e-5 (online softmax chunk by chunk in the kernel, one
softmax in the plain versions). ALiBi goes in before the soft cap, as in the
TPU kernel; the JAX oracle adds it after, so the ALiBi case holds no soft
cap when it is compared with the oracle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.attention.backend import alibi_slopes
from aphrodite_tpu.attention.backend import (
    ref_ragged_paged_attention as jax_ref_ragged)
from aphrodite_tpu.attention.metadata import AttentionMetadata as JaxMD
from aphrodite_tpu.ops.decode_paged_attention import (
    decode_paged_attention as jax_decode_kernel)
from aphrodite_tpu_torch.attention.backend import paged_attention
from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.ops.cuda_build import H100_SMEM_OPTIN
from aphrodite_tpu_torch.ops.decode_paged_attention import (
    decode_launch_geometry, decode_paged_attention, decode_smem_bytes,
    decode_tc_smem_bytes, decode_uses_tensor_cores, decode_warps)
from aphrodite_tpu_torch.ops.window_decode_attention import (
    window_uses_tensor_cores)

# The JAX oracles under jit, as the JAX package runs them (eager, each of
# their jnp ops compiles on its own: most of these tests' time).
jax_ref_ragged = jax.jit(jax_ref_ragged, static_argnames=(
    "scale", "sliding_window", "logits_soft_cap", "chunk_attn",
    "blocksparse"))

ATOL = 1e-5
PAGE, KVH, NQ, L, LAYER = 16, 2, 4, 2, 1

# name: (seq_lens, options). Rows with seq_len 0 must give zeros.
CASES = {
    "plain": ([37, 1, 16, 70], {}),
    "sliding_window": ([70, 9, 33, 17], {"sliding_window": 16}),
    "soft_cap": ([70, 33, 5, 48], {"logits_soft_cap": 30.0}),
    "chunk_attn": ([70, 40, 12, 65], {"chunk_attn": 32}),
    "alibi": ([70, 33, 5, 48], {"alibi": True}),
    "empty_rows": ([0, 41, 0, 20], {"sliding_window": 8,
                                    "logits_soft_cap": 20.0}),
}


def _case(seq_lens, hd, seed=0, nq=NQ, kvh=KVH):
    rng = np.random.RandomState(seed)
    R = len(seq_lens)
    max_pages = -(-max(seq_lens) // PAGE) + 1
    P = R * max_pages + 1
    bt = (1 + rng.permutation(P - 1)[:R * max_pages]).reshape(
        R, max_pages).astype(np.int32)
    cache = (rng.randn(L, P, 2, kvh, PAGE, hd) * 0.5).astype(np.float32)
    q = (rng.randn(R, nq, hd) * 0.5).astype(np.float32)
    return q, cache, bt, np.asarray(seq_lens, np.int32)


def _options(kw, nq=NQ):
    """(port kwargs, JAX kernel kwargs) of a case's options."""
    kw = dict(kw)
    if kw.pop("alibi", False):
        slopes = np.array(alibi_slopes(nq), np.float32)
        return ({**kw, "alibi": torch.from_numpy(slopes)},
                {**kw, "alibi": tuple(float(x) for x in slopes)})
    return kw, kw


# (case, head_dim, query heads, KV heads): every case at head dims 64 and
# 256 (group 2); BLOOM-3b's and MPT-30B's head dims (80 and 112: 128-wide
# tensor-core tiles on the card) with ALiBi; groups past one 16-row mma
# tile (18, and Falcon-7B's 71 on one KV head, which the card cuts into
# row slices) with and without ALiBi.
DECODE_GEOMS = (
    [pytest.param(name, hd, NQ, KVH, id=f"{name}-{hd}")
     for hd in (64, 256) for name in sorted(CASES)]
    + [pytest.param("alibi", hd, NQ, KVH, id=f"alibi-{hd}")
       for hd in (80, 112)]
    + [pytest.param(name, 64, nq, 1, id=f"{name}-64-group{nq}")
       for name, nq in (("plain", 18), ("alibi", 71))])


@pytest.mark.parametrize("name,hd,nq,kvh", DECODE_GEOMS)
def test_decode_vs_jax_kernel_and_oracle(name, hd, nq, kvh):
    seq_lens, kw = CASES[name]
    q, cache, bt, sl = _case(seq_lens, hd, nq=nq, kvh=kvh)
    port_kw, jax_kw = _options(kw, nq)
    scale = hd ** -0.5
    t = torch.from_numpy
    got = decode_paged_attention(t(q), t(cache), LAYER, t(bt), t(sl), scale,
                                 **port_kw).numpy()
    live = sl > 0
    np.testing.assert_array_equal(got[~live], 0.0)
    kern, _ = jax_decode_kernel(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(bt), jnp.asarray(sl),
        scale, chunk_pages=2, interpret=True, layer_idx=LAYER, **jax_kw)
    np.testing.assert_allclose(got[live], np.asarray(kern)[live], rtol=0,
                               atol=ATOL)
    R = len(sl)
    md = JaxMD(
        token_req_idx=jnp.arange(R, dtype=jnp.int32),
        token_pos=jnp.asarray(sl - 1), slot_mapping=jnp.full((R,), -1),
        query_start_loc=jnp.arange(R + 1, dtype=jnp.int32),
        seq_lens=jnp.asarray(sl), block_tables=jnp.asarray(bt),
        num_reqs=jnp.asarray(R, jnp.int32),
        num_tokens=jnp.asarray(R, jnp.int32), decode_mode=True)
    oracle_kw = {k: (jnp.asarray(v.numpy()) if k == "alibi" else v)
                 for k, v in port_kw.items()}
    ref = jax_ref_ragged(jnp.asarray(q), jnp.asarray(cache[LAYER]), md,
                         scale, **oracle_kw)
    np.testing.assert_allclose(got[live], np.asarray(ref)[live], rtol=0,
                               atol=ATOL)


def test_alibi_goes_in_before_the_soft_cap():
    """With both options the port follows the TPU kernel, which caps the
    ALiBi-biased logit."""
    q, cache, bt, sl = _case([70, 33, 5, 48], 64, seed=3)
    port_kw, jax_kw = _options({"alibi": True, "logits_soft_cap": 5.0})
    t = torch.from_numpy
    got = decode_paged_attention(t(q), t(cache), LAYER, t(bt), t(sl), 0.125,
                                 **port_kw).numpy()
    kern, _ = jax_decode_kernel(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(bt), jnp.asarray(sl),
        0.125, chunk_pages=2, interpret=True, layer_idx=LAYER, **jax_kw)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=0, atol=ATOL)


def test_backend_sends_decode_mode_to_the_decode_kernel():
    q, cache, bt, sl = _case([37, 1, 16, 70], 64, seed=4)
    t = torch.from_numpy
    md = AttentionMetadata(
        token_req_idx=torch.arange(4, dtype=torch.int32),
        token_pos=t(sl - 1), slot_mapping=None, seq_lens=t(sl),
        block_tables=t(bt), decode_mode=True)
    got = paged_attention(t(q), t(cache), LAYER, md, 0.125,
                          sliding_window=16, logits_soft_cap=30.0)
    want = decode_paged_attention(t(q), t(cache), LAYER, t(bt), t(sl), 0.125,
                                  sliding_window=16, logits_soft_cap=30.0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(NotImplementedError):
        decode_paged_attention(t(q).bfloat16(), t(cache), LAYER, t(bt), t(sl),
                               0.125)


# An H100 SM's shared memory, and what the runtime reserves for each block
# (CUDA C Programming Guide, compute capability 9.0).
H100_SMEM_PER_SM, SMEM_RESERVED = 233472, 1024

# (group, head_dim): warps of the CUDA-core instance with an fp32 cache
# (None: as many as fit), and blocks an SM of the bf16 tensor-core
# instance. Every head_dim it takes (multiples of 16 up to 256: 64-wide
# tiles up to 64, five blocks an SM, 128- or 256-wide past it, three) at
# group 1, and groups past one 16-row mma tile (18, Falcon-7B's 71, 128).
DECODE_SIZING = {(2, 256): (2, 3), (8, 256): (2, 3), (4, 128): (4, 3),
                 (6, 128): (4, 3), (1, 64): (4, 5),
                 **{(1, hd): (None, 5 if hd <= 64 else 3)
                    for hd in range(16, 257, 16) if hd != 64},
                 **{(g, hd): (None, 5 if hd <= 64 else 3)
                    for g in (18, 71, 128) for hd in (64, 80, 112)}}


@pytest.mark.parametrize("group,hd", sorted(DECODE_SIZING))
def test_decode_launch_fits_an_h100(group, hd):
    """fp32 keeps the CUDA-core instance, sized to the card's shared
    memory; bf16 and fp16 run the split tensor-core instance at every
    head_dim that is a multiple of 16 and any group (its ring, 32-key
    tiles at width 256, leaves three blocks an SM past head_dim 64), and
    the CUDA-core instance at a head_dim that is not; the window kernel's
    gate stays at head dims 64, 128 and 256 and groups up to 16."""
    warps32, blocks = DECODE_SIZING[(group, hd)]
    tc, warps, smem = decode_launch_geometry(torch.float32, group, hd,
                                             H100_SMEM_OPTIN)
    assert not tc and warps in ((1, 2, 4) if warps32 is None else (warps32,))
    assert smem == decode_smem_bytes(group, hd, 4, warps) <= H100_SMEM_OPTIN
    if warps < 4:
        assert decode_smem_bytes(group, hd, 4, 2 * warps) > H100_SMEM_OPTIN
    for dt in (torch.bfloat16, torch.float16):
        assert decode_uses_tensor_cores(dt, group, hd)
        tc, warps, smem = decode_launch_geometry(dt, group, hd,
                                                 H100_SMEM_OPTIN)
        assert tc and warps == 4 and smem == decode_tc_smem_bytes(hd)
        assert H100_SMEM_PER_SM // (smem + SMEM_RESERVED) == blocks
        assert window_uses_tensor_cores(dt, group, hd) == (
            hd in (64, 128, 256) and group <= 16)
    assert not decode_uses_tensor_cores(torch.float32, group, hd)
    odd = hd + 8  # not a multiple of 16: the CUDA-core instance
    tc, warps, _ = decode_launch_geometry(torch.bfloat16, group, odd,
                                          H100_SMEM_OPTIN)
    assert not tc and warps == decode_warps(group, odd, 2, H100_SMEM_OPTIN)
    with pytest.raises(RuntimeError, match="the card allows 232448"):
        decode_warps(128, 640, 4, H100_SMEM_OPTIN)
