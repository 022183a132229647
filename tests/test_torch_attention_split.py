"""Sizing of the tensor-core attention instances, and the window kernel's
split-and-merge modelled in plain PyTorch (each split's unnormalized
(acc, m, l) over the tiles the plan gives it, merged in the kernel's
order) against the JAX package's window references.

Tolerance: fp32, atol 1e-5 (the two sum the same terms in another order).
The inputs are made from a seed with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.ops.cascade_attention import (
    ref_cascade_window_decode as jax_ref_cascade)
from aphrodite_tpu.ops.cascade_attention import (
    ref_shared_prefix_attention as jax_ref_shared)
from aphrodite_tpu.ops.window_decode_attention import (
    ref_window_decode_attention as jax_ref_window)
from aphrodite_tpu_torch.ops.cuda_build import H100_SMEM_OPTIN, H100_SMS
from aphrodite_tpu_torch.ops.ragged_paged_attention import (
    ragged_block_q, ragged_tc_block_q, ragged_tc_smem_bytes,
    ragged_uses_tensor_cores, ragged_work_item_tokens, tc_width)
from aphrodite_tpu_torch.ops.window_decode_attention import (
    SPLIT_KEYS, window_launch_geometry, window_max_tiles, window_plan,
    window_split_plan, window_tc_smem_bytes)

ATOL = 1e-5
T = torch.from_numpy


@pytest.mark.parametrize("hd", [64, 128, 256] + [
    hd for hd in range(16, 257, 16) if hd not in (64, 128, 256)])
@pytest.mark.parametrize("group", [1, 2, 4, 6, 8, 18, 71])
def test_ragged_tensor_core_sizing(group, hd):
    """At every head_dim that is a multiple of 16 up to 256: 128 rows a
    block up to head_dim 128, 64 past it, in whole groups of query rows
    (a group past a block's rows raises); the ring, sized by the tiles'
    width (64, 128 or 256, the narrowest that holds the head), fits an
    H100 with and without an fp8 cache; bf16 and fp16 take this sizing
    and fp32 keeps the scalar instance's, as bf16 does at a head_dim that
    is not a multiple of 16."""
    rows = 128 if hd <= 128 else 64
    width = 64 if hd <= 64 else 128 if hd <= 128 else 256
    assert tc_width(hd) == width
    assert ragged_tc_smem_bytes(hd) == ragged_tc_smem_bytes(width)
    assert ragged_tc_smem_bytes(hd, fp8=True) <= H100_SMEM_OPTIN
    if group > rows:
        with pytest.raises(RuntimeError, match=f"exceed the block's {rows}"):
            ragged_tc_block_q(group, hd, H100_SMEM_OPTIN)
        return
    block_q = ragged_tc_block_q(group, hd, H100_SMEM_OPTIN)
    assert block_q * group == rows - rows % group
    assert ragged_tc_smem_bytes(hd) <= H100_SMEM_OPTIN
    for dt in (torch.bfloat16, torch.float16):
        assert ragged_uses_tensor_cores(dt, hd)
        assert ragged_work_item_tokens(dt, group, hd,
                                       H100_SMEM_OPTIN) == block_q
        assert not ragged_uses_tensor_cores(dt, hd + 8)
    assert not ragged_uses_tensor_cores(torch.float32, hd)
    assert ragged_work_item_tokens(torch.float32, group, hd,
                                   H100_SMEM_OPTIN) == \
        ragged_block_q(group, hd, H100_SMEM_OPTIN)


def test_ragged_tensor_core_sizing_raises_past_its_rows():
    with pytest.raises(RuntimeError, match="exceed the block's 64"):
        ragged_tc_block_q(65, 256, H100_SMEM_OPTIN)
    with pytest.raises(RuntimeError, match="the card allows 100000"):
        ragged_tc_block_q(4, 128, 100000)


@pytest.mark.parametrize("dtype,hd,block_q", [
    ("bfloat16", 256, 32), ("bfloat16", 128, 64), ("bfloat16", 80, 64),
    ("bfloat16", 208, 32), ("bfloat16", 72, 64), ("float32", 256, 40)])
def test_runner_sizes_block_q_for_its_dtype(dtype, hd, block_q):
    """The runner asks for the instance its model's dtype runs: 64 rows of
    group 2 at head_dim 256 in bf16 (tensor cores), 80 in fp32; bf16 at a
    head_dim that is a multiple of 16 takes the tensor-core sizing of its
    tiles' width (128 rows at 80, 64 at 208), at one that is not (72) the
    scalar sizing."""
    from aphrodite_tpu_torch import LLM
    cfg = dict(vocab_size=64, hidden_size=64, num_hidden_layers=1,
               num_attention_heads=8, num_key_value_heads=4, head_dim=hd,
               intermediate_size=64, architectures=["LlamaForCausalLM"])
    llm = LLM("tiny", hf_config=cfg, tokenizer="unused", dtype=dtype,
              device="cpu", block_size=16, num_kv_blocks=8, max_num_seqs=2,
              max_num_batched_tokens=32, max_model_len=64)
    assert llm.engine.core.worker.runner.block_q == block_q


@pytest.mark.parametrize("group,hd", [(1, 64), (2, 256), (4, 128), (6, 128),
                                      (8, 256), (16, 128)])
def test_window_tensor_core_geometry(group, hd):
    tc, warps, smem = window_launch_geometry(torch.bfloat16, group, hd,
                                             H100_SMEM_OPTIN)
    assert tc and warps == 4 and smem == window_tc_smem_bytes(hd)
    assert smem <= H100_SMEM_OPTIN
    # Larger groups, other head dims and fp32 run the CUDA-core instance.
    for dt, g, d in ((torch.bfloat16, 17, hd), (torch.bfloat16, group, 96),
                     (torch.float32, group, hd)):
        assert not window_launch_geometry(dt, g, d, H100_SMEM_OPTIN)[0]


@pytest.mark.parametrize("blocks,tiles,sms,want", [
    (256, 9, 132, (3, 3)),    # Llama-3.1-8B decode: 32 x 8 (request, head)
    (64, 11, 132, (6, 2)),    # Qwen2.5-1.5B: 32 x 2
    (1024, 4, 132, (1, 4)),   # phase 14: 128 x 8, from the cascade's state
    (8, 129, 132, (65, 2)),   # one request at 8192 tokens
    (4, 1, 132, (1, 1)),      # fewer tiles than wanted splits
    (8, 3, 132, (2, 2)),      # at least two tiles a split
])
def test_window_split_plan(blocks, tiles, sms, want):
    splits, per = window_split_plan(blocks, tiles, sms)
    assert (splits, per) == want
    assert splits * per >= tiles > (splits - 1) * per
    assert blocks * splits >= min(4 * sms, blocks * (tiles // 2 or 1))


def _request_tiles(plen, step, sliding_window, chunk_attn, shared_len):
    """The kernel's ``request_tiles``: (first visible page position, its
    tile, page tiles, all tiles); a chunk's start takes precedence over a
    sliding window, as in ``attn::first_visible``."""
    lo, q_pos = 0, plen + step
    if sliding_window:
        lo = q_pos - sliding_window + 1
    if chunk_attn:
        lo = (q_pos // chunk_attn) * chunk_attn
    lo = min(max(lo, shared_len, 0), plen)
    t0 = lo // SPLIT_KEYS
    n_paged = -(-plen // SPLIT_KEYS) - t0
    return lo, t0, n_paged, n_paged + -(-(step + 1) // SPLIT_KEYS)


def split_states(q, cache_layer, tail_k_l, tail_v_l, step, paged_lens,
                 block_tables, scale, sliding_window=None, chunk_attn=None,
                 logits_soft_cap=None, shared_len=0, max_paged_len=None,
                 num_sms=H100_SMS):
    """The kernel's splits, in fp32: for split 0, 1, ... the unnormalized
    state (acc [R, nq, hd], m [R, nq], l [R, nq]) of the tiles the plan
    gives it, the last split taking the rest; m = -inf where it saw no
    visible key. Page positions < ``shared_len`` are left to the cascade's
    init state."""
    _, _, kvh, page, hd = cache_layer.shape
    R, nq, _ = q.shape
    group = nq // kvh
    if max_paged_len is None:
        max_paged_len = block_tables.shape[1] * page
    sw, ch = sliding_window or 0, chunk_attn or 0
    splits, per = window_split_plan(
        R * kvh, window_max_tiles(max_paged_len, step, shared_len,
                                  sliding_window, chunk_attn), num_sms)
    acc = torch.zeros((splits, R, nq, hd))
    m = torch.full((splits, R, nq), float("-inf"))
    lsum = torch.zeros((splits, R, nq))
    ar = torch.arange(SPLIT_KEYS)
    for r in range(R):
        plen = int(paged_lens[r])
        q_pos = plen + step
        lo, t0, n_paged, n = _request_tiles(plen, step, sw, ch, shared_len)
        qf = q[r].float().reshape(kvh, group, hd)
        for sp in range(splits):
            keys, vals, oks = [], [], []
            end = n if sp == splits - 1 else min(sp * per + per, n)
            for t in range(sp * per, end):
                if t < n_paged:
                    pos = (t0 + t) * SPLIT_KEYS + ar
                    ok = (pos >= lo) & (pos < plen)
                    p = pos.clamp(max=plen - 1)
                    kv = cache_layer[block_tables[r, p // page].long(), :, :,
                                     p % page]          # [64, 2, kvh, hd]
                    keys.append(kv[:, 0].transpose(0, 1))
                    vals.append(kv[:, 1].transpose(0, 1))
                else:
                    j = (t - n_paged) * SPLIT_KEYS + ar
                    ok = j <= step
                    pos = plen + j
                    keys.append(tail_k_l[r][:, j.clamp(max=step)])
                    vals.append(tail_v_l[r][:, j.clamp(max=step)])
                if sw:
                    ok &= pos > q_pos - sw
                if ch:
                    ok &= pos // ch == q_pos // ch
                oks.append(ok)
            if not oks:
                continue
            k, v = torch.cat(keys, 1).float(), torch.cat(vals, 1).float()
            s = torch.einsum("hgd,hkd->hgk", qf, k) * scale
            if logits_soft_cap is not None:
                s = logits_soft_cap * torch.tanh(s / logits_soft_cap)
            s = s.masked_fill(~torch.cat(oks)[None, None], float("-inf"))
            mx = s.amax(-1)
            e = torch.exp(s - torch.where(torch.isfinite(mx), mx,
                                          torch.zeros_like(mx))[..., None])
            acc[sp, r] = torch.einsum("hgk,hkd->hgd", e, v).reshape(nq, hd)
            m[sp, r] = mx.reshape(nq)
            lsum[sp, r] = e.sum(-1).reshape(nq)
    return [(acc[i], m[i], lsum[i]) for i in range(splits)]


def merge_states(states, init=None):
    """The kernel's merge: the init state (if any), then each state in
    order, scaled to the common max; acc / max(l, 1e-20). States with m =
    -inf add nothing, and a row that no state covers gives 0."""
    if init is not None:
        acc0, m0, l0 = init
        R, kvh, group, hd = acc0.shape
        states = [(acc0.reshape(R, kvh * group, hd),
                   m0.reshape(R, kvh * group),
                   l0.reshape(R, kvh * group))] + list(states)
    m = states[0][1]
    for _, ms, _ in states[1:]:
        m = torch.maximum(m, ms)
    m_fin = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    acc = torch.zeros_like(states[0][0])
    lsum = torch.zeros_like(m)
    for a, ms, ls in states:
        c = torch.where(torch.isfinite(ms), torch.exp(ms - m_fin),
                        torch.zeros_like(ms))
        acc = acc + a * c[..., None]
        lsum = lsum + ls * c
    return acc / lsum.clamp(min=1e-20)[..., None]


def split_merge(*args, cascade_init=None, **kw):
    """The window as the kernel splits and merges it."""
    return merge_states(split_states(*args, **kw), cascade_init).numpy()


def _jnp(t):
    return jnp.asarray(t.numpy())


# The JAX references under jit, as the JAX package runs them (eager, each
# of their jnp ops compiles on its own: most of this file's time).
_REF_WINDOW = jax.jit(jax_ref_window, static_argnames=(
    "scale", "sliding_window", "chunk_attn", "logits_soft_cap"))
_REF_CASCADE = jax.jit(jax_ref_cascade, static_argnames=("scale",))
_REF_SHARED = jax.jit(jax_ref_shared, static_argnames=("scale",))


def jax_window(args, **opts):
    """The JAX package's plain window over the whole context."""
    q, cache, tk, tv, step, pl, bt, scale = args
    return np.asarray(_REF_WINDOW(
        _jnp(q), _jnp(cache), _jnp(tk), _jnp(tv), jnp.int32(step), _jnp(pl),
        _jnp(bt), scale=scale, **opts))


def jax_cascade(args, pages, S):
    """The JAX package's cascade: the shared pass's state merged with the
    window over page positions >= S."""
    q, cache, tk, tv, step, pl, bt, scale = args[:8]
    return np.asarray(_REF_CASCADE(
        _jnp(q), _jnp(cache), _jnp(tk), _jnp(tv), jnp.int32(step), _jnp(pl),
        _jnp(bt), _jnp(pages), jnp.int32(S), scale=scale))


def jax_shared_state(args, pages, S):
    """The JAX shared-prefix pass's (acc, m, l) as torch tensors."""
    q, cache, scale = args[0], args[1], args[7]
    return tuple(torch.from_numpy(np.array(t)) for t in _REF_SHARED(
        _jnp(q), _jnp(cache), _jnp(pages), jnp.int32(S), scale=scale))


def _window_case(plens, step, page, seed, shared=0, kw=8, kvh=2, nq=6,
                 hd=32):
    """Requests with shuffled pages; the first -(-shared // page) pages of
    every request are the same physical pages."""
    rng = np.random.RandomState(seed)
    R = len(plens)
    n_shared = -(-shared // page)
    own = [-(-p // page) - n_shared for p in plens]
    max_pages = max(-(-p // page) for p in plens) + 1
    P = 1 + n_shared + sum(max(o, 0) for o in own)
    perm = rng.permutation(np.arange(1, P)).astype(np.int32)
    bt = np.zeros((R, max_pages), np.int32)
    bt[:, :n_shared] = perm[:n_shared]
    o = n_shared
    for r, n in enumerate(own):
        bt[r, n_shared:n_shared + max(n, 0)] = perm[o:o + max(n, 0)]
        o += max(n, 0)
    cache = rng.randn(P, 2, kvh, page, hd).astype(np.float32) * 0.5
    tk = rng.randn(R, kvh, kw, hd).astype(np.float32) * 0.5
    tv = rng.randn(R, kvh, kw, hd).astype(np.float32) * 0.5
    q = rng.randn(R, nq, hd).astype(np.float32) * 0.5
    return (T(q), T(cache), T(tk), T(tv), step,
            T(np.asarray(plens, np.int32)), T(bt), hd ** -0.5,
            T(perm[:n_shared]))


SPLIT_CASES = {
    # tiles of 64 keys over 128-token pages: split edges fall mid-page
    "edges_mid_page": ([300, 129, 77, 5], 3, 128, {}, 8),
    # 16-token pages, uneven lengths, soft cap
    "pages16_soft_cap": ([250, 16, 99], 5, 16,
                         {"logits_soft_cap": 20.0}, 16),
    # a sliding window empties the splits before it (m = -inf)
    "sliding_window": ([600, 40, 300], 2, 16, {"sliding_window": 32}, 64),
    # a chunk bounds the range even with a narrower window set
    "chunk_and_window": ([700, 260], 6, 32,
                         {"chunk_attn": 128, "sliding_window": 16}, 64),
    "empty_context": ([0, 70], 0, 16, {}, 16),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_window_split_merge_equals_the_plain_window(name):
    """Against the JAX window with the plan bounded as the runner bounds
    it, by the block tables' capacity (more tiles planned), and by 0 (one
    split, which takes every tile)."""
    plens, step, page, opts, sms = SPLIT_CASES[name]
    args = _window_case(plens, step, page, seed=len(name))[:8]
    want = jax_window(args, **opts)
    for bound in (max(plens), None, 0):
        got = split_merge(*args, **opts, num_sms=sms, max_paged_len=bound)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    states = split_states(*args, **opts, num_sms=sms)
    assert len(states) > 1
    if name == "sliding_window":
        assert any(torch.isneginf(m).any() for _, m, _ in states)


@pytest.mark.parametrize("S,step", [(16 + 7, 2), (64, 5), (128 + 7, 0)])
def test_window_split_merge_from_the_cascade_state(S, step):
    """A cascade boundary at S = page + 7 (and on a tile edge): the splits
    read page positions >= S and the shared pass's state merges first;
    the result equals the JAX cascade and the JAX window over the whole
    context."""
    plens = [S + 90, S + 1, S + 300]
    args = _window_case(plens, step, 16, seed=S, shared=S)
    pages = args[8]
    init = jax_shared_state(args, pages, S)
    got = split_merge(*args[:8], cascade_init=init, shared_len=S,
                      num_sms=8, max_paged_len=max(plens))
    np.testing.assert_allclose(got, jax_cascade(args, pages, S), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got, jax_window(args[:8]), rtol=0, atol=ATOL)


def test_merge_of_a_fully_masked_row_is_zero():
    """States with m = -inf add nothing; a row no state covers gives 0."""
    R, nq, hd = 2, 4, 8
    acc = torch.ones((R, nq, hd))
    m = torch.full((R, nq), float("-inf"))
    lsum = torch.ones((R, nq))
    live = (torch.full((R, nq, hd), 3.0), torch.zeros((R, nq)),
            torch.full((R, nq), 2.0))
    m_live = live[1].clone()
    m_live[0] = float("-inf")   # request 0 fully masked in every state
    out = merge_states([(acc, m, lsum), (live[0], m_live, live[2])])
    assert torch.isfinite(out).all()
    assert not out[0].any()
    np.testing.assert_allclose(out[1].numpy(), 1.5, rtol=0, atol=ATOL)
    init = (torch.ones((R, 2, 2, hd)), torch.full((R, 2, 2), float("-inf")),
            torch.zeros((R, 2, 2)))
    out = merge_states([(acc, m, lsum)], init)
    assert torch.isfinite(out).all() and not out.any()


def test_window_max_tiles_bounds_every_request():
    """The plan's bound covers each request's own tiles (a bound too low
    would cost the kernel speed: its last split would take the rest), and
    the split-and-merge under that plan equals the JAX window."""
    for plens, step, opts, shared in (
            ([8192], 5, {}, 0), ([8192, 3], 63, {"sliding_window": 256}, 0),
            ([1000, 1030], 10, {"chunk_attn": 256}, 0),
            ([1152, 1100], 24, {}, 1024), ([40, 1000], 1, {}, 64)):
        n = window_max_tiles(max(plens), step, shared, **opts)
        for plen in plens:
            assert _request_tiles(plen, step, opts.get("sliding_window"),
                                  opts.get("chunk_attn"), shared)[3] <= n
        args = _window_case(plens, step, 64, seed=1, shared=shared,
                            kw=64, hd=16)
        init, want = None, jax_window(args[:8], **opts)
        if shared:
            init = jax_shared_state(args, args[8], shared)
            want = jax_cascade(args, args[8], shared)
        got = split_merge(*args[:8], **opts, cascade_init=init,
                          shared_len=shared, num_sms=132,
                          max_paged_len=max(plens))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("dtype,group,hd", [("bfloat16", 4, 128),
                                            ("float32", 6, 128),
                                            ("bfloat16", 2, 256)])
def test_window_plan_sizes_its_scratch(dtype, group, hd):
    """A window's plan: the launch geometry of its dtype and heads, a split
    plan that covers the bound's tiles, and a scratch of every split's
    (acc, m, l)."""
    dt = getattr(torch, dtype)
    R, kvh, bound, step = 32, 8 // group * 2, 1100, 40
    plan = window_plan(dt, R, kvh * group, kvh, hd, "cpu", bound, step)
    assert plan.key == (dt, R, kvh * group, kvh, hd)
    assert (plan.tensor_cores, plan.warps, plan.smem) == \
        window_launch_geometry(dt, group, hd, H100_SMEM_OPTIN)
    assert (plan.splits, plan.tiles_per_split) == window_split_plan(
        R * kvh, window_max_tiles(bound, step), H100_SMS)
    assert plan.part.dtype == torch.float32
    assert plan.part.numel() == R * kvh * group * plan.splits * (hd + 2)


def test_a_lost_split_exceeds_the_chip_limit():
    """chip_smoke's context-8192 window case (one request, 32 / 8 heads of
    128, bf16 inputs) holds the kernel at 2e-2 x min(1, max|ref|): the
    output averages ~8k values, so it is small, and dropping any one of
    the plan's splits moves it past that limit; an unscaled 2e-2 misses
    most such losses."""
    rng = np.random.RandomState(0)
    plen, step, page, kvh, nq, hd = 8192, 63, 64, 8, 32, 128

    def bf16(*shape):
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        return x.bfloat16().float()
    n_pages = plen // page
    cache = bf16(n_pages + 1, 2, kvh, page, hd)
    bt = torch.arange(1, n_pages + 1, dtype=torch.int32)[None]
    plens = torch.tensor([plen], dtype=torch.int32)
    args = (bf16(1, nq, hd), cache, bf16(1, kvh, 64, hd),
            bf16(1, kvh, 64, hd), step, plens, bt, hd ** -0.5)
    states = split_states(*args, max_paged_len=plen)
    assert len(states) == 65
    full = merge_states(states)
    limit = 2e-2 * min(1.0, full.abs().max().item())
    errs = [(merge_states(states[:i] + states[i + 1:]) - full).abs().max()
            for i in range(len(states))]
    assert min(errs) > limit
    assert sum(e < 2e-2 for e in errs) > len(errs) // 2
