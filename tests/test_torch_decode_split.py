"""The bf16 decode kernel's split plan (``decode_plan``) and grid
(``decode_blocks``), with its split-and-merge modelled in plain PyTorch
(each split's unnormalized (acc, m, l) over the tiles the plan gives it,
merged in the kernel's order), against the JAX package's
``decode_paged_attention`` Pallas kernel in interpret mode and its
``ref_ragged_paged_attention`` oracle with decode metadata, on the same
numpy inputs. The plain version and the launch sizing are in
``test_torch_decode_attention.py``, whose cases and tolerance this file
shares (fp32, atol 1e-5; ALiBi before the soft cap, so the ALiBi case
holds no soft cap where it meets the oracle)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.attention.metadata import AttentionMetadata as JaxMD
from aphrodite_tpu.ops.decode_paged_attention import (
    decode_paged_attention as jax_decode_kernel)
from aphrodite_tpu_torch.ops.cuda_build import H100_SMS
from aphrodite_tpu_torch.ops.decode_paged_attention import (
    decode_blocks, decode_max_tiles, decode_paged_attention, decode_plan,
    decode_row_slices, decode_tile_keys, ref_decode_paged_attention)
from aphrodite_tpu_torch.ops.window_decode_attention import (
    window_split_plan)
from tests.test_torch_attention_split import merge_states
from tests.test_torch_decode_attention import (ATOL, KVH, LAYER, NQ, L,
                                               _options, jax_ref_ragged)


def _tiles(seq_len, keys, sliding_window=None, chunk_attn=None):
    """The kernel's tiles of a request: (first visible key, its tile, the
    tile count); a row with seq_len 0 has none. Both the window's and the
    chunk's bound hold."""
    pos = seq_len - 1
    if pos < 0:
        return 0, 0, 0
    lo = 0
    if sliding_window:
        lo = max(lo, pos - sliding_window + 1)
    if chunk_attn:
        lo = max(lo, pos // chunk_attn * chunk_attn)
    return lo, lo // keys, pos // keys + 1 - lo // keys


def _split_ranges(n, splits, per):
    """Tiles [a, b) of each split (the kernel's ``my_tiles``): ``per``
    each, fewer at the request's end, the last split taking the rest."""
    return [(sp * per, n if sp == splits - 1 else min(sp * per + per, n))
            for sp in range(splits)]


@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("opts", [{}, {"sliding_window": 100},
                                  {"chunk_attn": 96}], ids=str)
@pytest.mark.parametrize("page", [16, 32, 64])
def test_decode_plan_covers_every_tile_at_every_sub_step(page, opts, hd):
    """A window's plan, bounded by the longest context of its last sub-step
    (with the layer's options, and without them as the runner makes it for
    every layer), gives every request's tiles at every sub-step to exactly
    one split, none of them past the plan; a plan bounded by 0 is one
    split, which takes every tile; one bounded too low still covers every
    tile through its last split."""
    seq_lens0 = [1, 37, 64, 65, 300 + page, 517]
    K, R, nq, kvh = 16, len(seq_lens0), 8, 2
    keys = decode_tile_keys(hd)
    bound = max(seq_lens0) + K - 1
    plans = [decode_plan(torch.bfloat16, R, nq, kvh, hd, "cpu", bound,
                         **opts),
             decode_plan(torch.bfloat16, R, nq, kvh, hd, "cpu", bound)]
    low = decode_plan(torch.bfloat16, R, nq, kvh, hd, "cpu", 64)
    zero = decode_plan(torch.bfloat16, R, nq, kvh, hd, "cpu", 0)
    assert zero.splits == 1
    for plan in plans + [low, zero]:
        assert plan.tensor_cores and plan.part.numel() == \
            R * nq * plan.splits * (hd + 2)
    for i in range(K):
        for s0 in seq_lens0:
            n = _tiles(s0 + i, keys, **opts)[2]
            assert n <= decode_max_tiles(bound, keys, **opts)
            for j, plan in enumerate(plans + [low, zero]):
                ranges = _split_ranges(n, plan.splits, plan.tiles_per_split)
                covered = [t for a, b in ranges for t in range(a, b)]
                assert covered == list(range(n))
                if j < len(plans):  # a bound that holds: none past it
                    assert n <= plan.splits * plan.tiles_per_split
            assert _split_ranges(n, 1, zero.tiles_per_split) == [(0, n)]


def decode_split_states(q, cache_layer, bt, seq_lens, scale, splits, per,
                        keys, sliding_window=None, chunk_attn=None,
                        logits_soft_cap=None, alibi=None):
    """The kernel's splits, in fp32: for split 0, 1, ... the unnormalized
    state (acc [R, nq, hd], m [R, nq], l [R, nq]) of the tiles the plan
    gives it, m in the scaled logit's units (ALiBi added before the soft
    cap); m = -inf where the split saw no visible key."""
    _, _, kvh, page, hd = cache_layer.shape
    R, nq, _ = q.shape
    group = nq // kvh
    acc = torch.zeros((splits, R, nq, hd))
    m = torch.full((splits, R, nq), float("-inf"))
    lsum = torch.zeros((splits, R, nq))
    for r in range(R):
        pos = int(seq_lens[r]) - 1
        lo, t0, n = _tiles(pos + 1, keys, sliding_window, chunk_attn)
        qf = q[r].float().reshape(kvh, group, hd)
        for sp, (a, b) in enumerate(_split_ranges(n, splits, per)):
            if a >= b:
                continue
            p = torch.arange((t0 + a) * keys, (t0 + b) * keys)
            ok = (p >= lo) & (p <= pos)
            pc = p.clamp(0, pos)
            kv = cache_layer[bt[r, pc // page].long(), :, :, pc % page]
            k = kv[:, 0].transpose(0, 1).float()     # [kvh, n, hd]
            v = kv[:, 1].transpose(0, 1).float()
            s = torch.einsum("hgd,hkd->hgk", qf, k) * scale
            if alibi is not None:
                s = s + (alibi.float().reshape(kvh, group)[..., None]
                         * (p - pos).float())
            if logits_soft_cap is not None:
                s = logits_soft_cap * torch.tanh(s / logits_soft_cap)
            s = s.masked_fill(~ok, float("-inf"))
            mx = s.amax(-1)
            e = torch.exp(s - torch.where(torch.isfinite(mx), mx,
                                          torch.zeros_like(mx))[..., None])
            acc[sp, r] = torch.einsum("hgk,hkd->hgd", e, v).reshape(nq, hd)
            m[sp, r] = mx.reshape(nq)
            lsum[sp, r] = e.sum(-1).reshape(nq)
    return [(acc[i], m[i], lsum[i]) for i in range(splits)]


# name: (seq_lens, page, options), long enough for several splits.
SPLIT_CASES = {
    "plain": ([300, 1, 16, 170], 16, {}),
    "sliding_window": ([300, 9, 133, 217], 32, {"sliding_window": 48}),
    "soft_cap": ([300, 133, 5, 248], 64, {"logits_soft_cap": 30.0}),
    "chunk_attn": ([300, 140, 12, 265], 16, {"chunk_attn": 96}),
    "alibi": ([300, 133, 5, 248], 32, {"alibi": True}),
    "empty_rows": ([0, 241, 0, 120], 64, {"sliding_window": 40,
                                          "logits_soft_cap": 20.0}),
}


def _split_case(seq_lens, page, hd, seed, nq=NQ, kvh=KVH):
    rng = np.random.RandomState(seed)
    R = len(seq_lens)
    max_pages = -(-max(seq_lens) // page) + 1
    P = R * max_pages + 1
    bt = (1 + rng.permutation(P - 1)[:R * max_pages]).reshape(
        R, max_pages).astype(np.int32)
    cache = (rng.randn(L, P, 2, kvh, page, hd) * 0.5).astype(np.float32)
    q = (rng.randn(R, nq, hd) * 0.5).astype(np.float32)
    return q, cache, bt, np.asarray(seq_lens, np.int32)


@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_decode_split_merge_vs_jax_kernel_and_oracle(name, hd):
    """The split-and-merge under the bf16 plan, bounded by the longest
    context with and without the layer's window or chunk (the runner makes
    one plan for every layer), by the block tables' capacity (the wrapper's
    default) and by 0 (one split), equals the JAX kernel in interpret mode
    and its oracle (and the port's plain version)."""
    seq_lens, page, kw = SPLIT_CASES[name]
    q, cache, bt, sl = _split_case(seq_lens, page, hd, seed=len(name))
    port_kw, jax_kw = _options(kw)
    scale = hd ** -0.5
    t = torch.from_numpy
    kern, _ = jax_decode_kernel(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(bt), jnp.asarray(sl),
        scale, chunk_pages=2, interpret=True, layer_idx=LAYER, **jax_kw)
    kern = np.asarray(kern)
    plain = decode_paged_attention(t(q), t(cache), LAYER, t(bt), t(sl),
                                   scale, **port_kw).numpy()
    live = sl > 0
    R = len(sl)
    plan_opts = {k: v for k, v in port_kw.items()
                 if k in ("sliding_window", "chunk_attn")}
    splits_seen = []
    for bound, bound_opts in ((max(seq_lens), plan_opts), (max(seq_lens), {}),
                              (bt.shape[1] * page, plan_opts), (0, {})):
        plan = decode_plan(torch.bfloat16, R, NQ, KVH, hd, "cpu", bound,
                           **bound_opts)
        splits_seen.append(plan.splits)
        got = merge_states(decode_split_states(
            t(q), t(cache[LAYER]), t(bt), t(sl), scale, plan.splits,
            plan.tiles_per_split, decode_tile_keys(hd), **port_kw)).numpy()
        np.testing.assert_array_equal(got[~live], 0.0)
        np.testing.assert_allclose(got[live], kern[live], rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, plain, rtol=0, atol=ATOL)
    assert max(splits_seen) > 1 and splits_seen[-1] == 1
    if "alibi" in kw:   # the oracle adds ALiBi after the cap: none here
        assert "logits_soft_cap" not in kw
    md = JaxMD(
        token_req_idx=jnp.arange(R, dtype=jnp.int32),
        token_pos=jnp.asarray(sl - 1), slot_mapping=jnp.full((R,), -1),
        query_start_loc=jnp.arange(R + 1, dtype=jnp.int32),
        seq_lens=jnp.asarray(sl), block_tables=jnp.asarray(bt),
        num_reqs=jnp.asarray(R, jnp.int32),
        num_tokens=jnp.asarray(R, jnp.int32), decode_mode=True)
    oracle_kw = {k: (jnp.asarray(v.numpy()) if k == "alibi" else v)
                 for k, v in port_kw.items()}
    ref = np.asarray(jax_ref_ragged(jnp.asarray(q), jnp.asarray(cache[LAYER]),
                                    md, scale, **oracle_kw))
    np.testing.assert_allclose(got[live], ref[live], rtol=0, atol=ATOL)


def test_a_lost_decode_split_exceeds_the_chip_limit():
    """chip_smoke's Gemma-2-9B decode case (32 requests, 16 / 8 heads of
    256, contexts 513-576, soft cap 50, bf16 inputs, the plan bounded by
    the longest context) holds the kernel at 2e-2 x min(1, max|ref|):
    dropping any one of the plan's splits moves the output past that
    limit."""
    rng = np.random.RandomState(0)
    ctx = [513 + (37 * r) % 64 for r in range(32)]
    R, nq, kvh, hd, page = len(ctx), 16, 8, 256, 64

    def bf16(*shape):
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        return x.bfloat16().float()
    n_pages = -(-max(ctx) // page)
    cache = bf16(R * n_pages + 1, 2, kvh, page, hd)
    bt = torch.arange(1, R * n_pages + 1, dtype=torch.int32).reshape(
        R, n_pages)
    sl = torch.tensor(ctx, dtype=torch.int32)
    plan = decode_plan(torch.bfloat16, R, nq, kvh, hd, "cpu", max(ctx))
    assert plan.splits == 3
    states = decode_split_states(bf16(R, nq, hd), cache, bt, sl, hd ** -0.5,
                                 plan.splits, plan.tiles_per_split,
                                 decode_tile_keys(hd), logits_soft_cap=50.0)
    full = merge_states(states)
    limit = 2e-2 * min(1.0, full.abs().max().item())
    errs = [(merge_states(states[:i] + states[i + 1:]) - full).abs().max()
            for i in range(len(states))]
    assert min(errs) > limit


@pytest.mark.parametrize("blocks,bound,hd,want", [
    (256, 639, 256, (4, 6)),   # Gemma-2-9B: its window's last sub-step
    (256, 576, 128, (3, 3)),   # Llama-3.1-8B heads, contexts 513-576
    (8, 8192, 128, (64, 2)),   # one request at 8192 tokens, 8 KV heads
    (256, 0, 256, (1, 1)),     # bounded by 0: one split
])
def test_decode_split_plan(blocks, bound, hd, want):
    """The plan's splits: about four blocks an SM, whole tiles of
    ``decode_tile_keys``, at least two a split where there are two."""
    tiles = decode_max_tiles(bound, decode_tile_keys(hd))
    splits, per = window_split_plan(blocks, tiles, H100_SMS)
    assert (splits, per) == want
    assert splits * per >= tiles > (splits - 1) * per


@pytest.mark.parametrize("nq,kvh", [(4, 2), (32, 2), (18, 1), (71, 1),
                                    (128, 1)])
@pytest.mark.parametrize("opts", [{}, {"sliding_window": 100},
                                  {"chunk_attn": 96}], ids=str)
def test_decode_blocks_cover_every_row_and_tile_once(opts, nq, kvh):
    """The tensor-core grid (``decode_blocks``: request, KV head, slice of
    at most 16 query heads of that KV head's group, split) under the plan
    bounded by the longest context, by too low a bound and by 0 gives
    every (request, query head, visible tile) to exactly one block; a
    block's tiles are its split's (the split model's ``_split_ranges``),
    so a row's states merge in the order 0, 1, ... of the splits; the
    plan counts the row slices in its blocks."""
    hd, group = 80, nq // kvh
    seq_lens = [1, 37, 64, 65, 364, 517, 0]
    keys = decode_tile_keys(hd)
    R = len(seq_lens)
    plans = [decode_plan(torch.bfloat16, R, nq, kvh, hd, "cpu", b, **opts)
             for b in (max(seq_lens), 64, 0)]
    slices = decode_row_slices(group)
    assert slices == -(-group // 16)
    assert plans[0].splits == window_split_plan(
        R * kvh * slices, decode_max_tiles(max(seq_lens), keys, **opts),
        H100_SMS)[0]
    for plan in plans:
        blocks = decode_blocks(plan, seq_lens, **opts)
        assert len(blocks) == R * kvh * slices * plan.splits
        seen = {}
        for b in blocks:
            assert 0 < len(b.heads) <= 16
            assert all(hh // group == b.kv_head for hh in b.heads)
            for hh in b.heads:
                for t in b.tiles:
                    key = (b.req, hh, t)
                    assert key not in seen
                    seen[key] = b.split
        for r, n_seq in enumerate(seq_lens):
            lo, t0, n = _tiles(n_seq, keys, **opts)
            ranges = _split_ranges(n, plan.splits, plan.tiles_per_split)
            for hh in range(nq):
                got = sorted((t, sp) for (rr, h2, t), sp in seen.items()
                             if rr == r and h2 == hh)
                want = [(t0 + t, sp) for sp, (a, b_) in enumerate(ranges)
                        for t in range(a, b_)]
                assert got == want


def test_decode_row_slices_merge_to_the_plain_version():
    """At Falcon-7B's group (71 query heads on one KV head, five row
    slices) and BLOOM-3b's head_dim 80 with ALiBi, the states of the
    plan's blocks merged in split order equal the plain version."""
    seq_lens, nq, kvh, hd = [300, 133, 5, 248], 71, 1, 80
    q, cache, bt, sl = _split_case(seq_lens, 32, hd, seed=7, nq=nq, kvh=kvh)
    port_kw, _ = _options({"alibi": True}, nq)
    t = torch.from_numpy
    scale = hd ** -0.5
    plan = decode_plan(torch.bfloat16, len(sl), nq, kvh, hd, "cpu",
                       max(seq_lens))
    assert plan.splits > 1
    got = merge_states(decode_split_states(
        t(q), t(cache[LAYER]), t(bt), t(sl), scale, plan.splits,
        plan.tiles_per_split, decode_tile_keys(hd), **port_kw))
    want = ref_decode_paged_attention(t(q), t(cache[LAYER]), t(bt), t(sl),
                                      scale, **port_kw)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
