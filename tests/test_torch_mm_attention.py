"""Bidirectional image spans in the port's ragged attention: the plain
version (which the CUDA wrapper runs on CPU tensors) against the JAX
package's Pallas kernel in interpret mode and against its XLA oracle, on
the same numpy inputs.

A query and a key that both lie in one image span of the query's request
see each other in either order, below the request's seq_len, before the
sliding window (``ragged_paged_attention.py:173-184``, oracle
``attention/backend.py:179-191``). The wave holds a prompt with two spans
that cross 16-token work items, a later chunk whose span began in an
earlier chunk, a chunk whose span runs past the keys written so far, and a
text row without spans; Gemma-3's sliding window (8 keys, shorter than the
spans) and a soft cap are cases of their own, in fp32 and fp16 (Gemma-3
multimodal served in fp16: the fp16 span instances on the card), and ALiBi
beside the spans (a pair no model has, which the tensor-core span
instances take) at head_dim 64 and 128, with and without a soft cap, in
fp32, bf16 and fp16. Tolerances: fp32 atol 1e-5 (online softmax chunk by
chunk in the kernel, one softmax in the plain version); in 16 bits the
Pallas kernel takes both products on q's dtype (P rounded to it) where the
plain version computes in fp32 and rounds once: a few ulps of outputs
below 1, fp16 atol 2e-3 (``test_torch_fp16.py``'s), bf16 atol 1.6e-2 (8
times fp16's: 3 fewer mantissa bits); measured 4.9e-4 and 7.8e-3, one
ulp of outputs of 1.1-1.6. The JAX oracle adds ALiBi after the
soft cap, the kernel before it: with both, the Pallas kernel alone is the
reference."""
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
from aphrodite_tpu_torch.attention.backend import alibi_slopes
from aphrodite_tpu_torch.attention.metadata import (AttentionMetadata,
                                                    build_work_items)
from aphrodite_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention)

# The JAX oracles under jit, as the JAX package runs them (eager, each of
# their jnp ops compiles on its own: most of these tests' time).
jax_ref_ragged = jax.jit(jax_ref_ragged, static_argnames=(
    "scale", "sliding_window", "logits_soft_cap", "chunk_attn",
    "blocksparse"))

ATOL = {"float32": 1e-5, "float16": 2e-3, "bfloat16": 1.6e-2}
PAGE, L, LAYER, HD, BLOCK_Q = 16, 2, 1, 32, 16
NQ, KVH = 8, 4   # Gemma-3-4B's group of 2
# Each request: (context length, tokens scheduled now, image spans).
REQS = [(40, 40, [(3, 14), (17, 35)]),   # two spans across work items
        (60, 20, [(30, 52)]),            # a chunk; the span began before
        (25, 1, []),                     # a text row (a decode token)
        (30, 12, [(20, 45)])]            # the span runs past the context
_OPTS = {"causal_spans": {}, "window8": {"sliding_window": 8},
         "soft_cap": {"logits_soft_cap": 5.0}}
# name: (options, q's and the cache's dtype, head_dim); "alibi" takes the
# slopes of NQ heads.
CASES = {**{n: (kw, "float32", HD) for n, kw in _OPTS.items()},
         **{f"fp16-{n}": (kw, "float16", HD) for n, kw in _OPTS.items()},
         "alibi-hd64-bf16": ({"alibi": True}, "bfloat16", 64),
         "alibi-hd128-fp16": ({"alibi": True}, "float16", 128),
         "alibi-softcap-hd128": ({"alibi": True, "logits_soft_cap": 5.0},
                                 "float32", 128)}


def _case(seed=0, hd=HD):
    rng = np.random.RandomState(seed)
    R = len(REQS)
    pages_per = [-(-c // PAGE) for c, _, _ in REQS]
    bt = np.zeros((R, max(pages_per) + 1), np.int32)
    perm = rng.permutation(np.arange(1, sum(pages_per) + 1))
    o = 0
    for r, n in enumerate(pages_per):
        bt[r, :n] = perm[o:o + n]
        o += n
    counts = [n for _, n, _ in REQS]
    spans = np.full((R, 2, 2), -1, np.int32)
    for r, (_, _, sp) in enumerate(REQS):
        for j, (lo, hi) in enumerate(sp):
            spans[r, j] = (lo, hi)
    return dict(
        q=(rng.randn(sum(counts), NQ, hd) * 0.5).astype(np.float32),
        cache=(rng.randn(L, sum(pages_per) + 1, 2, KVH, PAGE, hd)
               * 0.5).astype(np.float32),
        bt=bt, qsl=np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
        seq_lens=np.asarray([c for c, _, _ in REQS], np.int32),
        tok_req=np.repeat(np.arange(R), counts).astype(np.int32),
        tok_pos=np.concatenate([np.arange(c - n, c) for c, n, _ in REQS]
                               ).astype(np.int32),
        spans=spans, R=R, T=sum(counts))


def _port(c, dtype="float32", spans=True, alibi=False, **kw):
    t = torch.from_numpy
    items = build_work_items(c["qsl"][:-1], np.diff(c["qsl"]),
                             c["seq_lens"], c["R"], BLOCK_Q)
    md = AttentionMetadata(
        token_req_idx=t(c["tok_req"]), token_pos=t(c["tok_pos"]),
        slot_mapping=None, seq_lens=t(c["seq_lens"]),
        block_tables=t(c["bt"]), block_q=BLOCK_Q,
        mm_bidir_spans=t(c["spans"]) if spans else None,
        **{k: t(v) for k, v in items.items()})
    dt = getattr(torch, dtype)
    hd = c["q"].shape[-1]
    return ragged_paged_attention(
        t(c["q"]).to(dt), t(c["cache"]).to(dt), LAYER, md, hd ** -0.5,
        alibi=alibi_slopes(NQ) if alibi else None,
        **kw).float().numpy()


def _jax_md(c):
    md = JaxMD(
        token_req_idx=jnp.asarray(c["tok_req"]),
        token_pos=jnp.asarray(c["tok_pos"]),
        slot_mapping=jnp.zeros(c["T"], jnp.int32),
        query_start_loc=jnp.asarray(c["qsl"]),
        seq_lens=jnp.asarray(c["seq_lens"]),
        block_tables=jnp.asarray(c["bt"]),
        num_reqs=jnp.asarray(c["R"], jnp.int32),
        num_tokens=jnp.asarray(c["T"], jnp.int32),
        mm_bidir_spans=jnp.asarray(c["spans"]))
    items = jax_items(c["qsl"][:-1], np.diff(c["qsl"]), c["seq_lens"],
                      c["R"], c["T"], BLOCK_Q, c["R"])
    return dataclasses.replace(
        md, **{k: jnp.asarray(v) for k, v in items.items()})


@pytest.mark.parametrize("name", sorted(CASES))
def test_ragged_spans_vs_pallas_interpret_and_oracle(name):
    opts, dtype, hd = CASES[name]
    kw = {k: v for k, v in opts.items() if k != "alibi"}
    c = _case(hd=hd)
    got = _port(c, dtype, **opts)
    md = _jax_md(c)
    jdt = getattr(jnp, dtype)
    q, cache = (jnp.asarray(c[k]).astype(jdt) for k in ("q", "cache"))
    slopes = alibi_slopes(NQ).numpy() if opts.get("alibi") else None
    kern, _ = jax_ragged_kernel(
        q, cache, md, hd ** -0.5, block_q=BLOCK_Q, chunk_pages=1,
        interpret=True, layer_idx=LAYER, alibi=None if slopes is None
        else tuple(float(x) for x in slopes), **kw)
    assert kern.dtype == jdt
    atol = ATOL[dtype]
    np.testing.assert_allclose(got, np.asarray(kern, np.float32), rtol=0,
                               atol=atol)
    if slopes is None or "logits_soft_cap" not in kw:
        ref = jax_ref_ragged(q, cache[LAYER], md, hd ** -0.5, alibi=None
                             if slopes is None else jnp.asarray(slopes),
                             **kw)
        np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                                   rtol=0, atol=atol)
    # The spans move the outputs of their rows and of no other.
    causal = _port(c, dtype, spans=False, **opts)
    moved = np.abs(got - causal).max(axis=(1, 2)) > 1e-3
    in_span = np.zeros(c["T"], bool)
    for t, (r, p) in enumerate(zip(c["tok_req"], c["tok_pos"])):
        in_span[t] = any(lo <= p < hi for lo, hi in REQS[r][2])
    last = np.zeros(c["T"], bool)   # a span's last row sees no more keys
    for t, (r, p) in enumerate(zip(c["tok_req"], c["tok_pos"])):
        last[t] = any(p == min(hi, c["seq_lens"][r]) - 1
                      for _, hi in REQS[r][2])
    assert not moved[~in_span].any()
    assert moved[in_span & ~last].all()
