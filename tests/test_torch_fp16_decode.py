"""fp16 queries in the port's window, decode and shared-prefix wrappers,
against the JAX package in fp16 on the same numpy inputs (the rest of the
fp16 slice is in ``test_torch_fp16.py`` and ``test_torch_fp16_llm.py``):
their plain versions on fp16, e4m3 and e5m2 caches, the window with and
without the cascade's init state, the decode wrapper with ALiBi and the
shared pass at S = 0, 64 and 1000, against the Pallas kernels in
interpret mode and the JAX oracles, both run in fp16. Tolerances as in
``test_torch_fp16.py`` (atol 2e-3), but the window kernel rounds the
tail's P to the tails' dtype (e4m3 beside an e4m3 cache, bf16 beside
e5m2), as ``test_torch_fp8.py``'s ``test_window_fp8`` states: 5e-3 there.
The shared pass's state is fp32: acc and l rtol 2e-3 (P in fp16 in the
kernel), m 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.attention.metadata import AttentionMetadata as JaxMD
from aphrodite_tpu.ops import cascade_attention as jcascade
from aphrodite_tpu.ops.decode_paged_attention import (
    decode_paged_attention as jax_decode_kernel)
from aphrodite_tpu.ops.window_decode_attention import (
    ref_window_decode_attention as jax_ref_window)
from aphrodite_tpu.ops.window_decode_attention import (
    window_decode_attention as jax_window_kernel)
from aphrodite_tpu_torch.attention.backend import alibi_slopes
from aphrodite_tpu_torch.ops import cascade_attention as cascade
from aphrodite_tpu_torch.ops.decode_paged_attention import (
    decode_paged_attention)
from aphrodite_tpu_torch.ops.window_decode_attention import (
    tail_dtype, window_decode_attention)
from tests.test_torch_attention import KVH, LAYER, NQ, PAGE
from tests.test_torch_fp8 import to_torch
from tests.test_torch_fp16 import (ATOL, CACHES, L, T, _cache, _close,
                                   _f16, jax_ref_ragged)

TAIL_ATOL = 5e-3  # the window kernel's tail P in the tails' dtype

# The window oracle under jit (eager, each of its jnp ops compiles on its
# own).
jax_ref_window = jax.jit(jax_ref_window, static_argnames=(
    "scale", "sliding_window", "chunk_attn", "logits_soft_cap"))


# ------------------------------------------------------------ window
def _window_case(kind, seed=1, hd=64, kw=4, plens=(40, 13, 70, 0)):
    """A window on a cache of ``kind`` with fp16 queries and tails in the
    JAX runner's tail dtype beside it (fp16, e4m3, or bf16 beside e5m2),
    the same values in both packages."""
    rng = np.random.RandomState(seed)
    R, mp = len(plens), 6
    cache = (rng.randn(L, R * mp + 1, 2, KVH, PAGE, hd) * 0.3).astype(
        np.float32)
    jc, tc = _cache(cache, kind)
    bt = np.arange(1, R * mp + 1).reshape(R, mp).astype(np.int32)
    td = tail_dtype(CACHES[kind][1] if kind != "fp16" else torch.float16)
    jtd = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16,
           torch.float8_e4m3fn: jnp.float8_e4m3fn}[td]
    tails = [jnp.asarray((rng.randn(L, R, KVH, kw, hd) * 0.3).astype(
        np.float32)).astype(jtd) for _ in range(2)]
    jq, tq = _f16((rng.randn(R, NQ, hd) * 0.3).astype(np.float32))
    return (jq, tq, jc, tc, tails, [to_torch(t) for t in tails], bt,
            np.asarray(plens, np.int32))


# (cache, with the cascade's init state): both on fp16, the e4m3 tails
# alone, the bf16 tails beside e5m2 after the cascade's state.
WINDOW_RUNS = [("fp16", False), ("fp16", True), ("e4m3", False),
               ("e5m2", True)]


@pytest.mark.parametrize("kind,cascade_init", WINDOW_RUNS)
def test_window_fp16_vs_jax_kernel_and_oracle(kind, cascade_init):
    jq, tq, jc, tc, jt, tt, bt, pl = _window_case(kind)
    assert tt[0].dtype == {"fp16": torch.float16,
                           "e4m3": torch.float8_e4m3fn,
                           "e5m2": torch.bfloat16}[kind]
    step, scale = 3, 0.125
    init = j_init = None
    extra, jextra = {}, {}
    if cascade_init:  # the first page of every request, shared
        S, pages = PAGE, np.asarray([1], np.int32)
        bt = bt.copy()
        bt[:, 0] = 1
        pl = np.maximum(pl, PAGE + 1)
        init = cascade.shared_prefix_attention(tq, tc, LAYER, T(pages), S,
                                               scale)
        extra = dict(cascade_init=init, shared_len=S)
        j_init = jcascade.shared_prefix_attention(
            jq, jc, jnp.asarray(LAYER), jnp.asarray([1, 0], jnp.int32),
            jnp.asarray(S), scale, chunk_pages=1, interpret=True)
        jextra = dict(cascade_init=j_init, shared_len=jnp.asarray(S))
    got = window_decode_attention(tq, tc, tt[0], tt[1], LAYER, step, T(pl),
                                  T(bt), scale, **extra)
    kern = jax_window_kernel(jq, jc, jt[0], jt[1], jnp.int32(LAYER),
                             jnp.int32(step), jnp.asarray(pl),
                             jnp.asarray(bt), scale, chunk_pages=2,
                             interpret=True, **jextra)
    live = pl > 0
    atol = ATOL if kind == "fp16" else TAIL_ATOL
    _close(got[T(live)], np.asarray(kern)[live], atol)
    if cascade_init:
        ref = jcascade.ref_cascade_window_decode(
            jq, jc[LAYER], jt[0][LAYER], jt[1][LAYER], jnp.asarray(step),
            jnp.asarray(pl), jnp.asarray(bt), jnp.asarray([1, 0], jnp.int32),
            jnp.asarray(PAGE), scale)
    else:
        ref = jax_ref_window(jq, jc[LAYER], jt[0][LAYER], jt[1][LAYER],
                             jnp.int32(step), jnp.asarray(pl),
                             jnp.asarray(bt), scale)
    _close(got, ref)


# ------------------------------------------------------------ decode
@pytest.mark.parametrize("kind", sorted(CACHES))
def test_decode_alibi_fp16_vs_jax_kernel_and_oracle(kind):
    rng = np.random.RandomState(2)
    sl = np.asarray([37, 1, 16, 70], np.int32)
    R, hd, mp = len(sl), 64, 6
    cache = (rng.randn(L, R * mp + 1, 2, KVH, PAGE, hd) * 0.5).astype(
        np.float32)
    jc, tc = _cache(cache, kind)
    bt = (1 + rng.permutation(R * mp)).reshape(R, mp).astype(np.int32)
    jq, tq = _f16((rng.randn(R, NQ, hd) * 0.5).astype(np.float32))
    slopes = alibi_slopes(NQ)
    got = decode_paged_attention(tq, tc, LAYER, T(bt), T(sl), hd ** -0.5,
                                 alibi=slopes)
    kern, _ = jax_decode_kernel(jq, jc, jnp.asarray(bt), jnp.asarray(sl),
                                hd ** -0.5, chunk_pages=2, interpret=True,
                                layer_idx=LAYER,
                                alibi=tuple(float(s) for s in slopes))
    _close(got, kern)
    md = JaxMD(
        token_req_idx=jnp.arange(R, dtype=jnp.int32),
        token_pos=jnp.asarray(sl - 1), slot_mapping=jnp.full((R,), -1),
        query_start_loc=jnp.arange(R + 1, dtype=jnp.int32),
        seq_lens=jnp.asarray(sl), block_tables=jnp.asarray(bt),
        num_reqs=jnp.asarray(R, jnp.int32),
        num_tokens=jnp.asarray(R, jnp.int32), decode_mode=True)
    ref = jax_ref_ragged(jq, jc[LAYER], md, hd ** -0.5,
                         alibi=jnp.asarray(slopes.numpy()))
    _close(got, ref)


# ------------------------------------------------------ shared prefix
SHARED_RUNS = [(0, "fp16"), (64, "fp16"), (64, "e4m3"), (1000, "e5m2")]


@pytest.mark.parametrize("S,kind", SHARED_RUNS)
def test_shared_prefix_fp16_vs_jax_kernel_and_oracle(S, kind):
    rng = np.random.RandomState(S + 3)
    hd, R, n_pages = 64, 3, 64
    cache = (rng.randn(L, n_pages + 1, 2, KVH, PAGE, hd) * 0.3).astype(
        np.float32)
    jc, tc = _cache(cache, kind)
    jq, tq = _f16((rng.randn(R, NQ, hd) * 0.3).astype(np.float32))
    pages = (1 + rng.permutation(n_pages)).astype(np.int32)
    acc, m, lsum = cascade.shared_prefix_attention(tq, tc, 1, T(pages), S,
                                                   0.1)
    if S == 0:
        assert torch.isneginf(m).all() and not lsum.any() and not acc.any()
        return
    jp = jnp.asarray(pages)
    acc_k, m_k, l_k = jcascade.shared_prefix_attention(
        jq, jc, jnp.asarray(1), jp, jnp.asarray(S), 0.1, chunk_pages=2,
        interpret=True)
    acc_r, m_r, l_r = jcascade.ref_shared_prefix_attention(jq, jc[1], jp, S,
                                                          0.1)
    for a, mm, ll in ((acc_k, m_k[..., 0], l_k[..., 0]), (acc_r, m_r, l_r)):
        scale = np.asarray(ll, np.float32)[..., None]
        np.testing.assert_allclose(acc.numpy() / scale,
                                   np.asarray(a, np.float32) / scale,
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(m.numpy(), np.asarray(mm, np.float32),
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(lsum.numpy(), np.asarray(ll, np.float32),
                                   rtol=ATOL, atol=0)
