"""The port's cascade (shared-prefix) window decode vs the JAX package's,
on the same numpy inputs (the geometry of
``tests/ops/test_cascade_attention.py``):

- the shared pass's plain version vs the JAX ``shared_prefix_attention``
  in interpret mode and its ``ref_shared_prefix_attention`` (rtol/atol
  1e-4, as there);
- the window's plain version started from that state vs the JAX
  ``ref_cascade_window_decode``, vs the JAX window kernel with
  ``cascade_init`` in interpret mode, and vs the plain window over the whole
  context (1e-5, as there), for a prefix of whole pages and one that ends
  mid-page (S not a multiple of 32 or of the page);
- ``window_attention``'s cascade branch and the layers that bypass it;
- ``_detect_shared_prefix`` on the cases of
  ``tests/e2e/test_cascade_e2e.py:43-66``;
- the bf16 kernel's key-split plan (``shared_split_plan``) and its merge,
  modelled in plain PyTorch (each split's unnormalized state over the
  tiles the plan gives it, merged in split order) against the JAX
  ``shared_prefix_attention`` in interpret mode at S = 0, 64, 1000 and
  1024 (rtol/atol 1e-4, as above), and the shared-memory sizing of its
  tensor-core instance against an H100."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.ops import cascade_attention as jcascade
from aphrodite_tpu.ops.window_decode_attention import \
    window_decode_attention as jax_window_decode_attention
from aphrodite_tpu_torch import LLM
from aphrodite_tpu_torch.attention.backend import window_attention
from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.ops import cascade_attention as cascade
from aphrodite_tpu_torch.ops.cuda_build import H100_SMEM_OPTIN, H100_SMS
from aphrodite_tpu_torch.ops.window_decode_attention import (
    ref_window_decode_attention, window_decode_attention)

L, P, KVH, PS, HD = 2, 64, 2, 16, 64
NQ, GROUP = 6, 3
R, KW = 4, 8
SCALE = 0.1
T = torch.from_numpy


def setup(seed=0, shared_pages_n=2, suffix_pages=2):
    """test_cascade_attention.py:setup: R requests whose block tables start
    with the same pages, paged lengths past them."""
    rng = np.random.RandomState(seed)
    shared = list(range(1, 1 + shared_pages_n))
    S = shared_pages_n * PS
    bt = np.zeros((R, 8), np.int32)
    plens = np.zeros((R,), np.int32)
    nxt = 1 + shared_pages_n
    for r in range(R):
        nsuf = 1 + (r % suffix_pages)
        pages = shared + list(range(nxt, nxt + nsuf))
        nxt += nsuf
        bt[r, :len(pages)] = pages
        plens[r] = S + nsuf * PS - rng.randint(0, PS)
    cache = rng.randn(L, P, 2, KVH, PS, HD).astype(np.float32) * 0.3
    q = rng.randn(R, NQ, HD).astype(np.float32) * 0.3
    tk = rng.randn(L, R, KVH, KW, HD).astype(np.float32) * 0.3
    tv = rng.randn(L, R, KVH, KW, HD).astype(np.float32) * 0.3
    return q, cache, tk, tv, bt, plens, np.asarray(shared, np.int32), S


def _jax_pages(shared):
    return jnp.asarray(list(shared) + [0, 0], dtype=jnp.int32)


@pytest.mark.parametrize("seed,S", [(1, 2 * PS), (3, PS + 7)])
def test_shared_pass_vs_jax_kernel_and_oracle(seed, S):
    q, cache, _, _, _, _, shared, _ = setup(seed)
    pages = shared[:-(-S // PS)]
    acc, m, l = cascade.shared_prefix_attention(
        T(q), T(cache), 0, T(pages), S, SCALE)
    acc_k, m_k, l_k = jcascade.shared_prefix_attention(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(0), _jax_pages(pages),
        jnp.asarray(S), SCALE, chunk_pages=1, interpret=True)
    acc_r, m_r, l_r = jcascade.ref_shared_prefix_attention(
        jnp.asarray(q), jnp.asarray(cache[0]), _jax_pages(pages), S, SCALE)
    for a, mm, ll in ((acc_k, m_k[..., 0], l_k[..., 0]), (acc_r, m_r, l_r)):
        np.testing.assert_allclose(acc.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(m.numpy(), np.asarray(mm), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(l.numpy(), np.asarray(ll), rtol=1e-4,
                                   atol=1e-4)


def test_shared_pass_of_no_token_is_an_empty_state():
    q, cache, _, _, _, _, shared, _ = setup(4)
    acc, m, l = cascade.shared_prefix_attention(
        T(q), T(cache), 1, T(shared), 0, SCALE)
    assert torch.isneginf(m).all() and not l.any() and not acc.any()


@pytest.mark.parametrize("seed,S,step", [(2, 2 * PS, 2), (3, PS + 7, 1),
                                         (5, 2 * PS - 5, 7)])
def test_cascade_window_vs_jax_and_plain(seed, S, step):
    q, cache, tk, tv, bt, plens, shared, _ = setup(seed)
    pages = shared[:-(-S // PS)]
    init = cascade.shared_prefix_attention(T(q), T(cache), 0, T(pages), S,
                                           SCALE)
    got = window_decode_attention(
        T(q), T(cache), T(tk), T(tv), 0, step, T(plens), T(bt), SCALE,
        cascade_init=init, shared_len=S).numpy()
    plain = ref_window_decode_attention(
        T(q), T(cache[0]), T(tk[0]), T(tv[0]), step, T(plens), T(bt),
        SCALE).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        cascade.ref_cascade_window_decode(
            T(q), T(cache[0]), T(tk[0]), T(tv[0]), step, T(plens), T(bt),
            T(pages), S, SCALE).numpy(), got, rtol=0, atol=0)
    oracle = jcascade.ref_cascade_window_decode(
        jnp.asarray(q), jnp.asarray(cache[0]), jnp.asarray(tk[0]),
        jnp.asarray(tv[0]), jnp.asarray(step), jnp.asarray(plens),
        jnp.asarray(bt), _jax_pages(pages), jnp.asarray(S), SCALE)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=1e-5, atol=1e-5)
    j_init = jcascade.shared_prefix_attention(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(0), _jax_pages(pages),
        jnp.asarray(S), SCALE, chunk_pages=1, interpret=True)
    kern = jax_window_decode_attention(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(tk), jnp.asarray(tv),
        jnp.asarray(0), jnp.asarray(step), jnp.asarray(plens),
        jnp.asarray(bt), SCALE, chunk_pages=1, interpret=True,
        cascade_init=j_init, shared_len=jnp.asarray(S))
    np.testing.assert_allclose(got, np.asarray(kern), rtol=1e-4, atol=1e-4)


def _md(bt, plens, step, pages=None, S=None):
    return AttentionMetadata(
        token_req_idx=torch.arange(R, dtype=torch.int32),
        token_pos=T(plens) + step, slot_mapping=None,
        seq_lens=T(plens) + step + 1, block_tables=T(bt), window_step=step,
        paged_lens=T(plens), shared_pages=pages, shared_len=S)


def test_window_attention_cascade_branch(monkeypatch):
    q, cache, tk, tv, bt, plens, shared, S = setup(6)
    calls = []
    real = cascade.shared_prefix_attention
    monkeypatch.setattr(
        "aphrodite_tpu_torch.attention.backend.shared_prefix_attention",
        lambda *a, **k: calls.append(a) or real(*a, **k))
    args = (T(q), T(cache), T(tk), T(tv), 1)
    plain = window_attention(*args, _md(bt, plens, 3), SCALE)
    assert not calls
    got = window_attention(*args, _md(bt, plens, 3, T(shared), S), SCALE)
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    # A soft cap (or a sliding window, or chunked attention) bypasses the
    # cascade, as in the JAX backend.
    capped = window_attention(*args, _md(bt, plens, 3, T(shared), S), SCALE,
                              logits_soft_cap=5.0)
    assert len(calls) == 1
    np.testing.assert_allclose(
        capped.numpy(), window_attention(*args, _md(bt, plens, 3), SCALE,
                                         logits_soft_cap=5.0).numpy(),
        rtol=0, atol=0)


def test_cascade_init_refuses_local_masks():
    q, cache, tk, tv, bt, plens, shared, S = setup(7)
    init = cascade.shared_prefix_attention(T(q), T(cache), 0, T(shared), S,
                                           SCALE)
    with pytest.raises(ValueError):
        window_decode_attention(T(q), T(cache), T(tk), T(tv), 0, 0,
                                T(plens), T(bt), SCALE, sliding_window=8,
                                cascade_init=init, shared_len=S)


@pytest.fixture(scope="module")
def runner():
    llm = LLM("tiny", hf_config=dict(
        vocab_size=128, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=1, intermediate_size=64,
        architectures=["LlamaForCausalLM"]), tokenizer="unused",
        dtype="float32", device="cpu", block_size=16, num_kv_blocks=32,
        max_num_seqs=4, max_num_batched_tokens=64, max_model_len=256)
    return llm.engine.core.worker.runner


class _St:
    def __init__(self, blocks):
        self.block_ids = blocks


@pytest.mark.parametrize("tables,min_plen,want", [
    ({"a": [1, 2, 3, 4, 9], "b": [1, 2, 3, 4, 7, 8]}, 1000,
     ([1, 2, 3, 4], 64)),
    ({"a": [1, 2, 3, 4, 9], "b": [1, 2, 9, 4]}, 1000, None),   # diverges
    ({"a": [1, 2, 3, 4, 9], "b": [1, 2, 3, 4, 7]}, 40, None),  # min_plen
    ({"a": [1, 2, 3, 4, 5, 6], "b": [1, 2, 3, 4, 5, 7],
      "c": [1, 2, 3, 4, 5]}, 1000, ([1, 2, 3, 4, 5], 80)),
    ({"a": [1, 2, 3, 4, 5]}, 1000, None),                     # one request
])
def test_detect_shared_prefix(runner, tables, min_plen, want, monkeypatch):
    monkeypatch.setattr(runner, "requests",
                        {k: _St(v) for k, v in tables.items()})
    assert runner._detect_shared_prefix(sorted(tables), min_plen) == want


# ---------------------------------------------- the bf16 kernel's key splits
# An H100 SM's shared memory, and what the runtime reserves for each block.
H100_SMEM_PER_SM, SMEM_RESERVED = 233472, 1024


def shared_split_states(q, cache_layer, pages, S, scale, splits, per, keys):
    """The kernel's splits, in fp32: for split 0, 1, ... the unnormalized
    state (acc [R, kvh, group, hd], m, l [R, kvh, group]) of the shared
    key tiles the plan gives it (``per`` each, the last split taking the
    rest); m = -inf where a split has no key."""
    _, _, kvh, page, hd = cache_layer.shape
    R, nq, _ = q.shape
    group = nq // kvh
    n = -(-S // keys)
    qf = q.float().reshape(R, kvh, group, hd)
    states = []
    for sp in range(splits):
        a, b = sp * per, n if sp == splits - 1 else min(sp * per + per, n)
        acc = torch.zeros((R, kvh, group, hd))
        m = torch.full((R, kvh, group), float("-inf"))
        lsum = torch.zeros((R, kvh, group))
        if a < b:
            p = torch.arange(a * keys, b * keys)
            ok = p < S
            pc = p.clamp(max=S - 1)
            kv = cache_layer[pages[pc // page].long(), :, :, pc % page]
            k = kv[:, 0].transpose(0, 1).float()      # [kvh, n, hd]
            v = kv[:, 1].transpose(0, 1).float()
            s = torch.einsum("rhgd,hkd->rhgk", qf, k) * scale
            s = s.masked_fill(~ok, float("-inf"))
            m = s.amax(-1)
            e = torch.exp(s - m[..., None])
            acc = torch.einsum("rhgk,hkd->rhgd", e, v)
            lsum = e.sum(-1)
        states.append((acc, m, lsum))
    return states


def merge_shared(states):
    """The kernel's merge, in split order: the common max m, then acc and
    l of each split scaled to it; a row no split covers keeps m = -inf, l
    = 0, acc = 0."""
    m = states[0][1]
    for _, ms, _ in states[1:]:
        m = torch.maximum(m, ms)
    acc = torch.zeros_like(states[0][0])
    lsum = torch.zeros_like(m)
    for a, ms, ls in states:
        c = torch.where(torch.isfinite(ms), torch.exp(ms - m),
                        torch.zeros_like(ms))
        acc = acc + a * c[..., None]
        lsum = lsum + ls * c
    return acc, m, lsum


@pytest.mark.parametrize("S", [0, 64, 1000, 1024])
def test_shared_split_merge_vs_jax_kernel(S):
    """The bf16 kernel's plan for R 4, 6 / 2 heads of 64 over 32-token
    pages (64-key tiles that span two pages; eight splits of two tiles at
    S = 1024, one at 64, none at 0), modelled split by split and merged
    in order, equals the JAX pass in interpret mode and the port's plain
    version."""
    rng = np.random.RandomState(S)
    page, n_pages = 32, 33
    cache = rng.randn(1, n_pages + 1, 2, KVH, page, HD).astype(
        np.float32) * 0.3
    q = rng.randn(R, NQ, HD).astype(np.float32) * 0.3
    pages = (1 + rng.permutation(n_pages)).astype(np.int32)
    plan = cascade.shared_prefix_plan(torch.bfloat16, R, NQ, KVH, HD, S,
                                      "cpu")
    assert plan.tensor_cores
    assert (plan.splits, plan.tiles_per_split) == {
        0: (1, 1), 64: (1, 1), 1000: (8, 2), 1024: (8, 2)}[S]
    acc, m, lsum = merge_shared(shared_split_states(
        T(q), T(cache[0]), T(pages), S, SCALE, plan.splits,
        plan.tiles_per_split, cascade.spa_tile_keys(HD)))
    acc_k, m_k, l_k = jcascade.shared_prefix_attention(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(0),
        _jax_pages(pages), jnp.asarray(S), SCALE, chunk_pages=1,
        interpret=True)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_k), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(lsum.numpy(), np.asarray(l_k[..., 0]),
                               rtol=1e-4, atol=1e-4)
    if S == 0:
        assert torch.isneginf(m).all() and not lsum.any() and not acc.any()
    else:
        np.testing.assert_allclose(m.numpy(), np.asarray(m_k[..., 0]),
                                   rtol=1e-5, atol=1e-5)
    want = cascade.shared_prefix_attention(T(q), T(cache), 0, T(pages), S,
                                           SCALE)
    for got, w in zip((acc, m, lsum), want):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("blocks,tiles,want", [
    (64, 16, (4, 4)),     # phase 14: 8 row tiles x 8 KV heads, S = 1024
    (32, 16, (8, 2)),     # half as many blocks
    (64, 1, (1, 1)),      # S = 64: one tile
    (64, 0, (1, 1)),      # S = 0
    (2, 16, (8, 2)),      # few blocks: at least two tiles a split
    (1, 1000, (32, 32)),  # at most 32 splits
    (512, 16, (1, 16)),   # enough blocks already
])
def test_shared_split_plan(blocks, tiles, want):
    """About two blocks an SM, whole tiles a split, at least two where
    there are two, at most ``MAX_SPLITS`` splits; every tile in exactly
    one split."""
    splits, per = cascade.shared_split_plan(blocks, tiles, H100_SMS)
    assert (splits, per) == want
    assert splits <= cascade.MAX_SPLITS
    assert splits * per >= tiles
    assert tiles == 0 or (splits - 1) * per < tiles


@pytest.mark.parametrize("hd,blocks", [(64, 3), (128, 2), (256, 2)])
def test_shared_prefix_launch_fits_an_h100(hd, blocks):
    """The tensor-core instance's 64 query rows and K/V ring fit a block's
    shared memory, with two blocks an SM at least; its plan at phase 14's
    shapes holds the splits' scratch and zeroed counters, one a (row
    tile, KV head); fp32 keeps the CUDA-core instance and takes no
    split."""
    smem = cascade.spa_tc_smem_bytes(hd)
    assert smem <= H100_SMEM_OPTIN
    assert H100_SMEM_PER_SM // (smem + SMEM_RESERVED) == blocks
    plan = cascade.shared_prefix_plan(torch.bfloat16, 128, 32, 8, hd, 1024,
                                      "cpu")
    keys, row_tiles = cascade.spa_tile_keys(hd), 128 * 4 // cascade.TC_ROWS
    assert (plan.splits, plan.tiles_per_split) == cascade.shared_split_plan(
        row_tiles * 8, 1024 // keys, H100_SMS)
    assert plan.smem == smem and plan.splits > 1
    assert plan.part.numel() == plan.splits * 8 * 128 * 4 * (hd + 2)
    assert plan.counters.dtype == torch.int32 and not plan.counters.any()
    assert plan.counters.numel() == row_tiles * 8
    plan32 = cascade.shared_prefix_plan(torch.float32, 128, 32, 8, hd, 1024,
                                        "cpu")
    assert not plan32.tensor_cores and plan32.splits == 1
    assert plan32.part is None and plan32.smem == cascade.spa_smem_bytes(hd)
