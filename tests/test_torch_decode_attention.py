"""The port's decode paged attention (its plain version, which the CUDA
wrapper runs on CPU tensors) vs the JAX package's ``decode_paged_attention``
Pallas kernel in interpret mode and its ``ref_ragged_paged_attention``
oracle with decode metadata, on the same numpy inputs; and the launch sizing
of the decode kernel against an H100's shared memory.

Tolerance: fp32, atol 1e-5 (online softmax chunk by chunk in the kernel, one
softmax in the plain versions). ALiBi goes in before the soft cap, as in the
TPU kernel; the JAX oracle adds it after, so the ALiBi case holds no soft
cap when it is compared with the oracle."""
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
    decode_paged_attention, decode_smem_bytes, decode_warps)

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


def _case(seq_lens, hd, seed=0):
    rng = np.random.RandomState(seed)
    R = len(seq_lens)
    max_pages = -(-max(seq_lens) // PAGE) + 1
    P = R * max_pages + 1
    bt = (1 + rng.permutation(P - 1)[:R * max_pages]).reshape(
        R, max_pages).astype(np.int32)
    cache = (rng.randn(L, P, 2, KVH, PAGE, hd) * 0.5).astype(np.float32)
    q = (rng.randn(R, NQ, hd) * 0.5).astype(np.float32)
    return q, cache, bt, np.asarray(seq_lens, np.int32)


def _options(kw):
    """(port kwargs, JAX kernel kwargs) of a case's options."""
    kw = dict(kw)
    if kw.pop("alibi", False):
        slopes = np.array(alibi_slopes(NQ), np.float32)
        return ({**kw, "alibi": torch.from_numpy(slopes)},
                {**kw, "alibi": tuple(float(x) for x in slopes)})
    return kw, kw


@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_vs_jax_kernel_and_oracle(name, hd):
    seq_lens, kw = CASES[name]
    q, cache, bt, sl = _case(seq_lens, hd)
    port_kw, jax_kw = _options(kw)
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


# (group, head_dim): decode warps with an fp32 / a bf16 cache.
DECODE_WARPS = {(2, 256): (2, 4), (8, 256): (2, 4), (4, 128): (4, 4),
                (6, 128): (4, 4), (1, 64): (4, 4)}


@pytest.mark.parametrize("group,hd", sorted(DECODE_WARPS))
def test_decode_launch_fits_an_h100(group, hd):
    for itemsize, warps in zip((4, 2), DECODE_WARPS[(group, hd)]):
        assert decode_warps(group, hd, itemsize, H100_SMEM_OPTIN) == warps
        assert decode_smem_bytes(group, hd, itemsize,
                                 warps) <= H100_SMEM_OPTIN
        if warps < 4:
            assert decode_smem_bytes(group, hd, itemsize,
                                     2 * warps) > H100_SMEM_OPTIN
    with pytest.raises(RuntimeError, match="the card allows 232448"):
        decode_warps(128, 640, 4, H100_SMEM_OPTIN)
