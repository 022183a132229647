"""The port's attention (plain PyTorch versions, which the CUDA kernels'
wrappers run on CPU tensors) vs the JAX package's oracles and its Pallas
kernels in interpret mode, on the same numpy inputs.

Tolerance: fp32, atol 1e-5, compared on live tokens. The JAX Pallas
kernels accumulate an online softmax block by block; the port's plain
versions take one softmax; both in fp32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.attention.backend import (
    ref_ragged_paged_attention as jax_ref_ragged)
from aphrodite_tpu.attention.metadata import AttentionMetadata as JaxMD
from aphrodite_tpu.attention.metadata import build_work_items as jax_items
from aphrodite_tpu.ops.ragged_paged_attention import (
    ragged_paged_attention as jax_ragged_kernel)
from aphrodite_tpu.ops.window_decode_attention import (
    ref_window_decode_attention as jax_ref_window)
from aphrodite_tpu.ops.window_decode_attention import (
    window_decode_attention as jax_window_kernel)
from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.attention.metadata import build_work_items
from aphrodite_tpu_torch.ops.cuda_build import H100_SMEM_OPTIN
from aphrodite_tpu_torch.ops.ragged_paged_attention import (
    ragged_block_q, ragged_paged_attention, ragged_route, ragged_smem_bytes,
    ragged_tc_rows, ragged_work_item_tokens)
from aphrodite_tpu_torch.ops.window_decode_attention import (
    window_block_rows, window_decode_attention, window_launch_geometry,
    window_smem_bytes, window_tc_smem_bytes, window_warps)

# The JAX oracles under jit, as the JAX package runs them (eager, each of
# their jnp ops compiles on its own: most of these tests' time).
jax_ref_ragged = jax.jit(jax_ref_ragged, static_argnames=(
    "scale", "sliding_window", "logits_soft_cap", "chunk_attn",
    "blocksparse"))
jax_ref_window = jax.jit(jax_ref_window, static_argnames=(
    "scale", "sliding_window", "chunk_attn", "logits_soft_cap"))

ATOL = 1e-5
PAGE, KVH, NQ, L, LAYER = 16, 2, 4, 2, 1


def _ragged_case(reqs, hd=64, seed=0):
    """reqs: [(context_len, new_tokens)] — each request's last new_tokens
    positions are scheduled this step (prefill, chunk or decode)."""
    rng = np.random.RandomState(seed)
    R = len(reqs)
    pages_per = [-(-c // PAGE) for c, _ in reqs]
    max_pages = max(pages_per) + 1
    P = sum(pages_per) + 1
    perm = rng.permutation(np.arange(1, P))
    bt = np.zeros((R, max_pages), np.int32)
    o = 0
    for r, n in enumerate(pages_per):
        bt[r, :n] = perm[o:o + n]
        o += n
    counts = [n for _, n in reqs]
    qsl = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    seq_lens = np.asarray([c for c, _ in reqs], np.int32)
    tok_req = np.repeat(np.arange(R), counts).astype(np.int32)
    tok_pos = np.concatenate([np.arange(c - n, c) for c, n in reqs]
                             ).astype(np.int32)
    slots = (bt[tok_req, tok_pos // PAGE] * PAGE + tok_pos % PAGE
             ).astype(np.int32)
    T = len(tok_pos)
    cache = (rng.randn(L, P, 2, KVH, PAGE, hd) * 0.5).astype(np.float32)
    q = (rng.randn(T, NQ, hd) * 0.5).astype(np.float32)
    return dict(q=q, cache=cache, bt=bt, qsl=qsl, seq_lens=seq_lens,
                tok_req=tok_req, tok_pos=tok_pos, slots=slots, R=R, T=T)


def _port_ragged(c, spans=None, **kw):
    items = build_work_items(c["qsl"][:-1], np.diff(c["qsl"]),
                             c["seq_lens"], c["R"], 32)
    t = torch.from_numpy
    md = AttentionMetadata(
        token_req_idx=t(c["tok_req"]), token_pos=t(c["tok_pos"]),
        slot_mapping=t(c["slots"].astype(np.int64)),
        seq_lens=t(c["seq_lens"]),
        block_tables=t(c["bt"]), block_q=32,
        mm_bidir_spans=None if spans is None else t(spans),
        **{k: t(v) for k, v in items.items()})
    hd = c["q"].shape[-1]
    return ragged_paged_attention(t(c["q"]), t(c["cache"]), LAYER, md,
                                  hd ** -0.5, **kw).numpy()


def _jax_md(c, block_q=32):
    md = JaxMD(
        token_req_idx=jnp.asarray(c["tok_req"]),
        token_pos=jnp.asarray(c["tok_pos"]),
        slot_mapping=jnp.asarray(c["slots"]),
        query_start_loc=jnp.asarray(c["qsl"]),
        seq_lens=jnp.asarray(c["seq_lens"]),
        block_tables=jnp.asarray(c["bt"]),
        num_reqs=jnp.asarray(c["R"], jnp.int32),
        num_tokens=jnp.asarray(c["T"], jnp.int32))
    items = jax_items(c["qsl"][:-1], np.diff(c["qsl"]), c["seq_lens"],
                      c["R"], c["T"], block_q, c["R"])
    return dataclasses.replace(
        md, **{k: jnp.asarray(v) for k, v in items.items()})


RAGGED_CASES = {
    # mixed wave: two prefills and two decode rows on older context
    "mixed": ([(40, 40), (13, 13), (37, 1), (25, 1)], {}),
    # chunked prefill: later chunks of longer prompts
    "chunked": ([(60, 20), (33, 17), (18, 18)], {}),
    "sliding_window": ([(60, 60), (30, 1)], {"sliding_window": 16}),
    "soft_cap": ([(33, 33), (5, 5), (20, 1)], {"logits_soft_cap": 30.0}),
}


@pytest.mark.parametrize("name", sorted(RAGGED_CASES))
def test_ragged_vs_jax_oracle_and_kernel(name):
    reqs, kw = RAGGED_CASES[name]
    c = _ragged_case(reqs)
    got = _port_ragged(c, **kw)
    md = _jax_md(c)
    hd = c["q"].shape[-1]
    q = jnp.asarray(c["q"])
    ref = jax_ref_ragged(q, jnp.asarray(c["cache"][LAYER]), md, hd ** -0.5,
                         **kw)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)
    kern, _ = jax_ragged_kernel(q, jnp.asarray(c["cache"]), md, hd ** -0.5,
                                block_q=32, chunk_pages=2, interpret=True,
                                layer_idx=LAYER, **kw)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=0, atol=ATOL)


def test_ragged_work_items_cover_every_token_once():
    c = _ragged_case([(70, 70), (9, 1), (45, 12)])
    items = build_work_items(c["qsl"][:-1], np.diff(c["qsl"]),
                             c["seq_lens"], c["R"], 16)
    covered = np.zeros(c["T"], np.int32)
    for s, n, r, p in zip(items["item_qstart"], items["item_qlen"],
                          items["item_req"], items["item_pos"]):
        assert 0 < n <= 16
        covered[s:s + n] += 1
        np.testing.assert_array_equal(c["tok_req"][s:s + n], r)
        np.testing.assert_array_equal(c["tok_pos"][s:s + n],
                                      np.arange(p, p + n))
    np.testing.assert_array_equal(covered, 1)


WINDOW_CASES = {
    "step0": ([40, 13, 7, 0], 0, {}),
    "step2": ([40, 13, 7, 0], 2, {}),
    "step3_long": ([128, 1, 65, 33], 3, {}),
    "sliding_window": ([100, 30, 9], 2, {"sliding_window": 16}),
    "soft_cap": ([33, 5], 1, {"logits_soft_cap": 30.0}),
}


@pytest.mark.parametrize("name", sorted(WINDOW_CASES))
def test_window_vs_jax_oracle_and_kernel(name):
    plens, step, kw = WINDOW_CASES[name]
    rng = np.random.RandomState(1)
    hd, kwin, max_pages = 128, 4, 9
    R = len(plens)
    P = R * max_pages + 1
    cache = (rng.randn(L, P, 2, KVH, PAGE, hd) * 0.3).astype(np.float32)
    bt = np.stack([np.arange(1 + r * max_pages, 1 + (r + 1) * max_pages)
                   for r in range(R)]).astype(np.int32)
    tk = (rng.randn(L, R, KVH, kwin, hd) * 0.3).astype(np.float32)
    tv = (rng.randn(L, R, KVH, kwin, hd) * 0.3).astype(np.float32)
    q = (rng.randn(R, NQ, hd) * 0.3).astype(np.float32)
    pl = np.asarray(plens, np.int32)
    scale = hd ** -0.5
    t = torch.from_numpy
    got = window_decode_attention(t(q), t(cache), t(tk), t(tv), LAYER, step,
                                  t(pl), t(bt), scale, **kw).numpy()
    ref = jax_ref_window(jnp.asarray(q), jnp.asarray(cache[LAYER]),
                         jnp.asarray(tk[LAYER]), jnp.asarray(tv[LAYER]),
                         jnp.int32(step), jnp.asarray(pl), jnp.asarray(bt),
                         scale, **kw)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)
    kern = jax_window_kernel(jnp.asarray(q), jnp.asarray(cache),
                             jnp.asarray(tk), jnp.asarray(tv),
                             jnp.int32(LAYER), jnp.int32(step),
                             jnp.asarray(pl), jnp.asarray(bt), scale,
                             chunk_pages=2, interpret=True, **kw)
    live = pl > 0
    np.testing.assert_allclose(got[live], np.asarray(kern)[live], rtol=0,
                               atol=ATOL)


def test_unported_kernel_options_raise():
    # Image spans are ported (and ALiBi): they compute what the JAX oracle
    # computes; tests/test_torch_mm_attention.py holds them further.
    c = _ragged_case([(8, 8)])
    spans = np.asarray([[[2, 6]]], np.int32)
    got = _port_ragged(c, spans=spans)
    md = dataclasses.replace(_jax_md(c), mm_bidir_spans=jnp.asarray(spans))
    ref = jax_ref_ragged(jnp.asarray(c["q"]), jnp.asarray(c["cache"][LAYER]),
                         md, 64 ** -0.5)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)
    assert np.abs(got - _port_ragged(c)).max() > 1e-3
    with pytest.raises(NotImplementedError):  # a cache of neither q's dtype
        window_decode_attention(                # nor fp8 (fp8 is ported)
            torch.zeros(1, NQ, 64),
            torch.zeros(L, 2, 2, KVH, PAGE, 64, dtype=torch.bfloat16),
            torch.zeros(L, 1, KVH, 4, 64, dtype=torch.bfloat16),
            torch.zeros(L, 1, KVH, 4, 64, dtype=torch.bfloat16), 0,
            0, torch.ones(1, dtype=torch.int32),
            torch.ones(1, 1, dtype=torch.int32), 0.1)


def test_spans_at_the_mla_geometry_raise():
    """Image spans at the MLA geometry raise nowhere any more: bf16 and fp16
    at head_dim 576 route them (and ALiBi) to the MLA option instances
    (``csrc/mla_opts.cu``, ``csrc/mla_opts_f16.cu``) and keep the
    instances without options for calls without them; fp32 at 576 runs the
    scalar instance, which takes both. On the CPU every dtype computes the
    plain version, which the spans move: bf16 equals fp32's result on the
    same bf16 inputs, rounded once."""
    c = _ragged_case([(8, 8)], hd=576)
    spans = np.asarray([[[2, 6]]], np.int32)
    items = build_work_items(c["qsl"][:-1], np.diff(c["qsl"]),
                             c["seq_lens"], c["R"], 32)
    t = torch.from_numpy
    md = AttentionMetadata(
        token_req_idx=t(c["tok_req"]), token_pos=t(c["tok_pos"]),
        slot_mapping=None, seq_lens=t(c["seq_lens"]),
        block_tables=t(c["bt"]), block_q=32, mm_bidir_spans=t(spans),
        **{k: t(v) for k, v in items.items()})
    q, cache = t(c["q"]).bfloat16(), t(c["cache"]).bfloat16()
    got = ragged_paged_attention(q, cache, LAYER, md, 0.1)
    want = ragged_paged_attention(q.float(), cache.float(), LAYER, md, 0.1)
    assert torch.equal(got, want.bfloat16())
    md.mm_bidir_spans = None
    assert (got - ragged_paged_attention(q, cache, LAYER, md, 0.1)
            ).abs().max() > 1e-3
    for dt, suffix in ((torch.bfloat16, ""), (torch.float16, "_f16")):
        for spans_, alibi in ((True, False), (False, True), (True, True)):
            assert ragged_route(dt, 576, spans_, alibi) == (
                f"mla_opts{suffix}", f"mla_ragged_opts{suffix}_launch",
                "mla")
        assert ragged_route(dt, 576, False, False) == (
            f"mla_attention{suffix}", f"mla_ragged{suffix}_launch", "mla")
    assert ragged_route(torch.float32, 576, True, True)[2] == "scalar"


# Every (dtype, head_dim) the port serves: 576 is MLA's latent head,
# every multiple of 16 up to 256 the tensor-core instances' in 16 bits
# (in 64-, 128- or 256-wide tiles), 72 and 216 the scalar instance's.
ROUTE_GEOMS = [(dt, hd) for dt in ("float32", "bfloat16", "float16")
               for hd in (32, 64, 80, 128, 256, 576)] + [
    (dt, hd) for dt in ("bfloat16", "float16")
    for hd in [*range(16, 257, 16), 72, 208 + 8]
    if hd not in (32, 64, 80, 128, 256)]


@pytest.mark.parametrize("dtype,hd", ROUTE_GEOMS)
def test_ragged_route_names_a_built_entry(dtype, hd):
    """Each option of the TPU kernel (image spans, ALiBi, both, neither)
    routes to a hand-written instance at every dtype and head_dim: a
    ``csrc/<library>.cu`` of the port that defines the entry, the library
    in the wrapper's launch counts by source; the instance as the sizing
    predicates say (MLA, tensor cores, else scalar). None raises."""
    from aphrodite_tpu_torch.ops import cuda_build
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_uses_mla, ragged_uses_tensor_cores)
    dt = getattr(torch, dtype)
    kind = ("mla" if ragged_uses_mla(dt, hd) else "tensor_cores"
            if ragged_uses_tensor_cores(dt, hd) else "scalar")
    assert kind == ("scalar" if dtype == "float32" else "mla" if hd == 576
                    else "tensor_cores" if hd % 16 == 0 and hd <= 256
                    else "scalar")
    seen = set()
    for spans in (False, True):
        for alibi in (False, True):
            lib, sym, inst = ragged_route(dt, hd, spans, alibi)
            src = (cuda_build._CSRC / f"{lib}.cu").read_text()
            assert f'extern "C" int {sym}(' in src, (lib, sym)
            assert inst == kind
            assert lib in ragged_paged_attention.source_launches
            seen.add(lib)
    # The span switch and the MLA options are instances of their own;
    # the scalar instance takes every option in one.
    assert len(seen) == {"mla": 2, "tensor_cores": 2, "scalar": 1}[kind]


def test_reset_launches_zeros_every_count():
    """``reset_launches`` sets the ragged wrapper's every launch count to
    0 (in all, by instance, library and dtype, with spans) and keeps each
    table's keys."""
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        reset_launches)
    f = ragged_paged_attention
    tables = (f.instance_launches, f.source_launches, f.dtype_launches)
    keys = [set(t) for t in tables]
    saved = (f.launches, f.span_launches, *(dict(t) for t in tables))
    try:
        f.launches = f.span_launches = 3
        for t in tables:
            t.update(dict.fromkeys(t, 2))
        reset_launches()
        assert f.launches == f.span_launches == 0
        assert [set(t) for t in tables] == keys
        assert not any(v for t in tables for v in t.values())
    finally:
        f.launches, f.span_launches = saved[:2]
        for t, old in zip(tables, saved[2:]):
            t.update(old)


# (group, head_dim): ragged query rows a work item, window warps, of the
# instances that fp32 runs (bf16 runs the tensor-core ones at these).
# None: as many as fit (every multiple of 16 up to 256 at group 1; groups
# 18, 71 and 128 at BLOOM's, Falcon's and MPT's head dims).
LAUNCH_GEOMS = {
    (2, 256): (80, 2),    # Gemma-2-9B
    (4, 128): (128, 4),   # Llama-3.1-8B
    (6, 128): (126, 4),   # Qwen2.5-1.5B
    (8, 256): (80, 2),    # Gemma-2B (MQA)
    (1, 64): (128, 4),
    **{(1, hd): (None, None) for hd in range(16, 257, 16) if hd != 64},
    **{(g, hd): (None, None) for g in (18, 71, 128) for hd in (64, 80, 112)},
}


@pytest.mark.parametrize("group,hd", sorted(LAUNCH_GEOMS))
def test_launches_fit_an_h100(group, hd):
    """fp32's scalar ragged items and CUDA-core window blocks fit the
    card's shared memory; bf16's window runs its tensor-core instance only
    at head dims 64, 128 and 256 and groups up to 16 (its gate is
    unchanged), and the ragged kernel's tensor-core instance at every head
    dim that is a multiple of 16, sized by its tiles' width."""
    rows, w_warps = LAUNCH_GEOMS[(group, hd)]
    block_q = ragged_block_q(group, hd, H100_SMEM_OPTIN)
    if rows is None:
        rows = block_q * group
        assert rows <= max(128, group)
    assert block_q * group == rows
    assert ragged_smem_bytes(block_q, group, hd) <= H100_SMEM_OPTIN
    if rows + group <= 128:  # the shared memory, not the row cap, binds
        assert ragged_smem_bytes(block_q + 1, group, hd) > H100_SMEM_OPTIN
    if w_warps is None:
        w_warps = window_warps(group, hd, H100_SMEM_OPTIN)
    assert window_warps(group, hd, H100_SMEM_OPTIN) == w_warps
    w_rows = window_block_rows(group, hd, H100_SMEM_OPTIN)
    assert window_smem_bytes(w_rows, hd, w_warps) <= H100_SMEM_OPTIN
    assert window_launch_geometry(torch.float32, group, hd,
                                  H100_SMEM_OPTIN) == \
        (False, w_warps, window_smem_bytes(w_rows, hd, w_warps))
    if hd in (64, 128, 256) and group <= 16:
        assert window_launch_geometry(torch.bfloat16, group, hd,
                                      H100_SMEM_OPTIN) == \
            (True, 4, window_tc_smem_bytes(hd))
        assert window_tc_smem_bytes(hd) <= H100_SMEM_OPTIN
    else:
        assert not window_launch_geometry(torch.bfloat16, group, hd,
                                          H100_SMEM_OPTIN)[0]
    if group <= ragged_tc_rows(hd):
        assert ragged_work_item_tokens(torch.bfloat16, group, hd,
                                       H100_SMEM_OPTIN) == \
            ragged_tc_rows(hd) // group


def test_the_old_launch_sizes_overflow_at_head_dim_256():
    """The sizes the kernels had before: 128 ragged rows and 4 window
    warps need more than the H100's 232,448 bytes at head_dim 256."""
    assert ragged_smem_bytes(64, 2, 256) == 329856
    assert window_smem_bytes(2, 256, 4) == 273472
    assert ragged_smem_bytes(64, 2, 128) <= H100_SMEM_OPTIN


def test_a_geometry_that_cannot_fit_raises():
    # Since the scalar instances cut a group into row slices (MLA), only a
    # head_dim at which not even one query row fits raises.
    with pytest.raises(RuntimeError, match="needs 271496 bytes of shared "
                       "memory per block; the card allows 232448"):
        ragged_block_q(128, 1024, H100_SMEM_OPTIN)
    with pytest.raises(RuntimeError, match="the card allows 232448"):
        window_warps(128, 1024, H100_SMEM_OPTIN)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(RuntimeError, match="the card allows 232448"):
            window_launch_geometry(dtype, 128, 1024, H100_SMEM_OPTIN)


def test_runner_sizes_block_q_to_the_geometry():
    from aphrodite_tpu_torch import LLM
    for hd, block_q in ((256, 40), (128, 64)):
        cfg = dict(vocab_size=64, hidden_size=64, num_hidden_layers=1,
                   num_attention_heads=8, num_key_value_heads=4, head_dim=hd,
                   intermediate_size=64, architectures=["LlamaForCausalLM"])
        llm = LLM("tiny", hf_config=cfg, tokenizer="unused",
                  dtype="float32", device="cpu", block_size=16,
                  num_kv_blocks=8, max_num_seqs=2, max_num_batched_tokens=32,
                  max_model_len=64)
        assert llm.engine.core.worker.runner.block_q == block_q
