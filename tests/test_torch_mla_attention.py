"""The MLA geometry of the port's ragged and window attention: the plain
PyTorch versions (which the CUDA wrappers run on CPU tensors, and which
``chip_smoke.py`` holds the MLA instances against) vs the JAX package's
Pallas kernels in interpret mode, at one KV head of 576 lanes (DeepSeek's
latent head: 512 + 64) with groups of 16 (V2-Lite) and 128 (V2 / V3), over
a mixed wave with later chunks and over decode windows. Where interpret
mode wants 128-lane rows, the JAX runner's zero padding to 640 is used
(``aphrodite_tpu/attention/backend.py:33-41``) and the first 576 lanes
compared. Tolerance: fp32, atol 1e-5 on outputs of O(0.1).

The ragged kernel's options at the MLA geometry, which no JAX model
reaches and the MLA option instances take on the card: image spans, ALiBi,
both, and ALiBi beside a soft cap, each in bf16 and in fp16, on a cache of
q's dtype and on e4m3 (``OPT_RUNS``). There the Pallas kernel takes both
products in q's dtype (P rounded to it) and the plain version computes in
fp32 and rounds once: fp16 atol 2e-3, bf16 1.6e-2, as
``test_torch_mm_attention.py`` holds the tensor-core instances' twin
(measured 4.9e-4 and 3.9e-3: one ulp of outputs of ~1.1).

Also the launch sizing: both MLA instances fit an H100 at groups 16 and
128 (one block an SM), their work items, window split plan and TMA page
boxes, and the scalar instances, which sized one block for a whole group
before (739,456 bytes at group 128), now cut a group into row slices."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.attention.metadata import AttentionMetadata as JaxMD
from aphrodite_tpu.attention.metadata import build_work_items as jax_items
from aphrodite_tpu.ops.ragged_paged_attention import (
    ragged_paged_attention as jax_ragged_kernel)
from aphrodite_tpu.ops.window_decode_attention import (
    window_decode_attention as jax_window_kernel)
from aphrodite_tpu_torch.attention.backend import alibi_slopes
from aphrodite_tpu_torch.attention.metadata import (AttentionMetadata,
                                                    build_work_items)
from aphrodite_tpu_torch.ops.cuda_build import H100_SMEM_OPTIN, H100_SMS
from aphrodite_tpu_torch.ops.ragged_paged_attention import (
    MLA_KEYS, MLA_ROWS, mla_page_boxes, mla_smem_bytes, ragged_block_q,
    ragged_block_rows, ragged_paged_attention, ragged_smem_bytes,
    ragged_uses_mla, ragged_work_item_tokens)
from aphrodite_tpu_torch.ops.window_decode_attention import (
    window_block_rows, window_decode_attention, window_launch_geometry,
    window_plan, window_smem_bytes, window_split_plan, window_warps)
from tests.test_torch_fp8 import to_torch

ATOL = 1e-5
HD, PAD, PAGE, L, LAYER = 576, 640, 16, 2, 1


def _pad(a):
    """Zero lanes 576..639, as the JAX runner pads the latent head."""
    width = [(0, 0)] * (a.ndim - 1) + [(0, PAD - HD)]
    return np.pad(a, width)


def _tables(rng, ctx):
    """Shuffled block tables covering ctx tokens a request (page 0 null)."""
    pages = [-(-c // PAGE) for c in ctx]
    P = sum(pages) + 1
    perm = rng.permutation(np.arange(1, P))
    bt = np.zeros((len(ctx), max(pages) + 1), np.int32)
    o = 0
    for r, n in enumerate(pages):
        bt[r, :n] = perm[o:o + n]
        o += n
    return bt, P


RAGGED = {  # nq: [(context, new tokens)] (chunks sit past cached keys)
    "group16-mixed": (16, [(40, 40), (37, 17), (25, 1)]),
    "group128-chunks": (128, [(21, 21), (35, 6), (9, 1)]),
}
# The options on "group16-mixed": two spans of the prompt across work
# items, one of the chunk that began before it and runs past its context,
# none on the decode row.
_SPANS = [[(3, 14), (17, 35)], [(30, 52)], []]
OPTS = {"spans": dict(spans=_SPANS), "alibi": dict(alibi=True),
        "spans-alibi": dict(spans=_SPANS, alibi=True),
        "alibi-softcap": dict(alibi=True, logits_soft_cap=30.0)}
# name: (option, q's dtype, the cache's: q's or e4m3); each option in bf16
# and fp16, on each cache.
OPT_RUNS = {f"group16-{o}-{dt}-{kv}": (o, dt, kv) for o, dt, kv in (
    ("spans", "bfloat16", "16bit"), ("spans", "float16", "e4m3"),
    ("alibi", "float16", "16bit"), ("alibi", "bfloat16", "e4m3"),
    ("spans-alibi", "bfloat16", "16bit"), ("spans-alibi", "float16", "e4m3"),
    ("alibi-softcap", "float16", "16bit"),
    ("alibi-softcap", "bfloat16", "e4m3"))}
OPT_ATOL = {"float16": 2e-3, "bfloat16": 1.6e-2}


def _span_rows(spans):
    """[R, 2, 2] int32 image spans, -1 padding."""
    arr = np.full((len(spans), 2, 2), -1, np.int32)
    for r, sp in enumerate(spans):
        for j, lohi in enumerate(sp):
            arr[r, j] = lohi
    return arr


def _ragged_inputs(nq, reqs, rng, spans=None, alibi=False, **opts):
    """A mixed wave over requests of (context, new tokens) at the MLA
    geometry, drawn from ``rng``: its fp32 cache and q, the port's ragged
    wrapper and the Pallas kernel (interpret mode, 640 lanes) on them,
    each as a function of (q, cache) in its own framework; with the image
    ``spans`` of each request, ALiBi's slopes of nq heads and ``opts``."""
    ctx = [c for c, _ in reqs]
    bt, P = _tables(rng, ctx)
    counts = [n for _, n in reqs]
    R = len(reqs)
    qsl = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    seq_lens = np.asarray(ctx, np.int32)
    tok_req = np.repeat(np.arange(R), counts).astype(np.int32)
    tok_pos = np.concatenate([np.arange(c - n, c) for c, n in reqs]
                             ).astype(np.int32)
    slots = (bt[tok_req, tok_pos // PAGE] * PAGE + tok_pos % PAGE
             ).astype(np.int32)
    T = len(tok_pos)
    cache = (rng.randn(L, P, 2, 1, PAGE, HD) * 0.3).astype(np.float32)
    q = (rng.randn(T, nq, HD) * 0.3).astype(np.float32)
    scale = 192 ** -0.5  # DeepSeek's qk_head_dim, not the latent width
    sp = _span_rows(spans) if spans is not None else None
    slopes = alibi_slopes(nq) if alibi else None
    t = torch.from_numpy
    items = build_work_items(qsl[:-1], np.diff(qsl), seq_lens, R, 4)
    md = AttentionMetadata(
        token_req_idx=t(tok_req), token_pos=t(tok_pos),
        slot_mapping=t(slots.astype(np.int64)), seq_lens=t(seq_lens),
        block_tables=t(bt), block_q=4,
        mm_bidir_spans=None if sp is None else t(sp),
        **{k: t(v) for k, v in items.items()})
    jmd = JaxMD(
        token_req_idx=jnp.asarray(tok_req), token_pos=jnp.asarray(tok_pos),
        slot_mapping=jnp.asarray(slots), query_start_loc=jnp.asarray(qsl),
        seq_lens=jnp.asarray(seq_lens), block_tables=jnp.asarray(bt),
        num_reqs=jnp.asarray(R, jnp.int32), num_tokens=jnp.asarray(T,
                                                                   jnp.int32),
        mm_bidir_spans=None if sp is None else jnp.asarray(sp))
    block_q = 1 if nq > 16 else 8
    jmd = dataclasses.replace(jmd, **{
        k: jnp.asarray(v) for k, v in jax_items(
            qsl[:-1], np.diff(qsl), seq_lens, R, T, block_q, R).items()})
    return dict(
        cache=cache, q=q,
        port=lambda q_, c_: ragged_paged_attention(
            q_, c_, LAYER, md, scale, alibi=slopes, **opts),
        pallas=lambda q_, c_: jax_ragged_kernel(
            q_, c_, jmd, scale, block_q=block_q, chunk_pages=2,
            interpret=True, layer_idx=LAYER, alibi=None if slopes is None
            else tuple(float(x) for x in slopes), **opts)[0])


@pytest.mark.parametrize("name", sorted(RAGGED) + sorted(OPT_RUNS))
def test_ragged_plain_matches_pallas_at_mla_geometry(name):
    if name in RAGGED:
        (nq, reqs), opts, dt, kv = RAGGED[name], {}, "float32", "16bit"
    else:
        o, dt, kv = OPT_RUNS[name]
        (nq, reqs), opts = RAGGED["group16-mixed"], OPTS[o]
    inp = _ragged_inputs(nq, reqs, np.random.RandomState(0), **opts)
    jq = jnp.asarray(_pad(inp["q"])).astype(getattr(jnp, dt))
    jc = jq.dtype if kv == "16bit" else jnp.float8_e4m3fn
    jc = jnp.asarray(_pad(inp["cache"])).astype(jc)
    got = inp["port"](*(to_torch(np.array(a))[..., :HD].contiguous()
                        for a in (jq, jc)))
    assert got.dtype == getattr(torch, dt)
    kern = np.asarray(inp["pallas"](jq, jc), np.float32)
    np.testing.assert_array_equal(kern[..., HD:], 0)
    np.testing.assert_allclose(got.float().numpy(), kern[..., :HD], rtol=0,
                               atol=ATOL if dt == "float32"
                               else OPT_ATOL[dt])


WINDOW = {  # nq: paged lengths, window step
    "group16": (16, [40, 13, 70], 2),
    "group128": (128, [33, 5], 3),
}


@pytest.mark.parametrize("name", sorted(WINDOW))
def test_window_plain_matches_pallas_at_mla_geometry(name):
    nq, plens, step = WINDOW[name]
    rng = np.random.RandomState(1)
    kw, R = 4, len(plens)
    bt, P = _tables(rng, plens)
    cache = (rng.randn(L, P, 2, 1, PAGE, HD) * 0.3).astype(np.float32)
    tk = (rng.randn(L, R, 1, kw, HD) * 0.3).astype(np.float32)
    tv = (rng.randn(L, R, 1, kw, HD) * 0.3).astype(np.float32)
    q = (rng.randn(R, nq, HD) * 0.3).astype(np.float32)
    pl = np.asarray(plens, np.int32)
    scale = 192 ** -0.5
    t = torch.from_numpy
    got = window_decode_attention(t(q), t(cache), t(tk), t(tv), LAYER, step,
                                  t(pl), t(bt), scale).numpy()
    kern = np.asarray(jax_window_kernel(
        jnp.asarray(_pad(q)), jnp.asarray(_pad(cache)), jnp.asarray(_pad(tk)),
        jnp.asarray(_pad(tv)), jnp.int32(LAYER), jnp.int32(step),
        jnp.asarray(pl), jnp.asarray(bt), scale, chunk_pages=2,
        interpret=True))
    np.testing.assert_array_equal(kern[..., HD:], 0)
    np.testing.assert_allclose(got, kern[..., :HD], rtol=0, atol=ATOL)


# ------------------------------------------------------------------ sizing
@pytest.mark.parametrize("group", [16, 128])
def test_mla_instances_fit_an_h100(group):
    """One block shape for both instances: Q (73,728 bytes), a two-stage
    ring of 32-key K and V tiles (147,456), the window's hand-off of P
    (8,704), twelve mbarriers and 1024 bytes of alignment: one block an
    SM, of 16 warps."""
    assert ragged_uses_mla(torch.bfloat16, HD)
    assert mla_smem_bytes() == 231008 <= H100_SMEM_OPTIN
    block_q = ragged_work_item_tokens(torch.bfloat16, group, HD,
                                      H100_SMEM_OPTIN)
    assert block_q == max(1, 64 // group)  # V3: one token, two slices
    assert 2 * mla_smem_bytes() > H100_SMEM_OPTIN
    assert window_launch_geometry(torch.bfloat16, group, HD,
                                  H100_SMEM_OPTIN) == (True, 16, 231008)
    plan = window_plan(torch.bfloat16, 32, group, 1, HD, "cpu", 576, 62)
    assert plan.tensor_cores and plan.rows == 64


@pytest.mark.parametrize("group,tokens,slices", [(16, 4, 1), (128, 1, 2),
                                                 (64, 1, 1), (24, 2, 1)])
def test_mla_work_item_tokens(group, tokens, slices):
    """A work item fills the block's 64 rows with whole groups (V2-Lite's
    16 heads: 4 tokens), else takes one token whose group the kernel cuts
    into slices of 64 rows (V3's 128 heads: 2)."""
    block_q = ragged_work_item_tokens(torch.bfloat16, group, HD,
                                      H100_SMEM_OPTIN)
    assert block_q == tokens
    assert -(-block_q * group // MLA_ROWS) == slices


@pytest.mark.parametrize("reqs,group,tiles,waves_before", [
    (32, 16, 9, 2),    # V2-Lite's window sub-step: 513-576 keys
    (4, 128, 6, 1),    # V3's group of 128 at R = 4
    (256, 16, 9, 6),   # more (request, row tile) pairs than SMs
])
def test_mla_window_plans_whole_waves(reqs, group, tiles, waves_before):
    """The MLA instance fits one block an SM: its split plan fills at most
    one wave of 132 SMs where the pairs fit one (the four-a-SM plan left
    V2-Lite's sub-step a second wave of 28 blocks), with the fewest tiles
    a split that allows, and the splits cover the tiles."""
    pairs = reqs * -(-group // MLA_ROWS)
    splits, per = window_split_plan(pairs, tiles, H100_SMS, per_sm=1)
    assert splits * per >= tiles > (splits - 1) * per
    if pairs <= H100_SMS:
        assert pairs * splits <= H100_SMS
        # the fewest tiles a split that one wave allows
        assert per == -(-tiles // min(H100_SMS // pairs, tiles))
    else:
        assert splits == 1
    old = window_split_plan(pairs, tiles, H100_SMS)
    assert -(-pairs * old[0] // H100_SMS) == waves_before
    plan = window_plan(torch.bfloat16, reqs, group, 1, HD, "cpu",
                       64 * (tiles - 1), 63)
    assert (plan.splits, plan.tiles_per_split) == (splits, per)


@pytest.mark.parametrize("page,want", [(8, (8, 4)), (16, (16, 2)),
                                       (32, (32, 1)), (64, (32, 1)),
                                       (128, (32, 1))])
def test_mla_page_boxes(page, want):
    """A 32-key tile's TMA boxes: whole pages of 8 or 16 tokens (each box
    1024-byte aligned in the 128-byte swizzle), one 32-row box of a page
    of a multiple of 32 tokens."""
    rows, boxes = mla_page_boxes(page)
    assert (rows, boxes) == want and rows * boxes == MLA_KEYS
    assert rows * 128 % 1024 == 0


@pytest.mark.parametrize("page", [4, 24, 48, 100])
def test_mla_page_boxes_refuse_other_pages(page):
    with pytest.raises(ValueError, match="MLA attention instances"):
        mla_page_boxes(page)


def test_the_old_scalar_sizing_raised_at_group_128():
    """One block for a token's whole group: 739,456 bytes for the ragged
    instance, ~738 KB for the window's, against the H100's 232,448."""
    assert ragged_smem_bytes(1, 128, HD) == 739456 > H100_SMEM_OPTIN
    assert window_smem_bytes(128, HD, 1) > H100_SMEM_OPTIN
    # V2-Lite's group of 16 fitted, at one token a work item, one warp.
    assert ragged_smem_bytes(1, 16, HD) == 222464
    assert window_smem_bytes(16, HD, 1) == 221568


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [16, 128])
def test_scalar_instances_cut_a_group_into_row_slices(dtype, group):
    """No geometry of either dtype raises at group 128 any more: the
    scalar instances (fp32, and bf16 at head dims without a tensor-core
    instance) take 18 rows a block at head_dim 576."""
    block_q = ragged_block_q(group, HD, H100_SMEM_OPTIN)
    rows = ragged_block_rows(group, HD, H100_SMEM_OPTIN, block_q)
    assert (block_q, rows) == (1, min(group, 18))
    assert ragged_smem_bytes(1, rows, HD) <= H100_SMEM_OPTIN
    assert ragged_smem_bytes(1, rows + 1, HD) > H100_SMEM_OPTIN or \
        rows == group
    assert window_block_rows(group, HD, H100_SMEM_OPTIN) == min(group, 18)
    assert window_warps(group, HD, H100_SMEM_OPTIN) == 1
    tc, warps, smem = window_launch_geometry(torch.float32, group, HD,
                                             H100_SMEM_OPTIN)
    assert (tc, warps) == (False, 1) and smem <= H100_SMEM_OPTIN
    if dtype == torch.float32:
        plan = window_plan(dtype, 4, group, 1, HD, "cpu", 300, 3)
        assert not plan.tensor_cores and plan.rows == min(group, 18)
