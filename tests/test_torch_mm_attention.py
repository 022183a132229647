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
spans) and a soft cap are cases of their own. Tolerance: fp32, atol 1e-5
(online softmax chunk by chunk in the kernel, one softmax in the plain
version)."""
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
from aphrodite_tpu_torch.attention.metadata import (AttentionMetadata,
                                                    build_work_items)
from aphrodite_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention)

# The JAX oracles under jit, as the JAX package runs them (eager, each of
# their jnp ops compiles on its own: most of these tests' time).
jax_ref_ragged = jax.jit(jax_ref_ragged, static_argnames=(
    "scale", "sliding_window", "logits_soft_cap", "chunk_attn",
    "blocksparse"))

ATOL = 1e-5
PAGE, L, LAYER, HD, BLOCK_Q = 16, 2, 1, 32, 16
NQ, KVH = 8, 4   # Gemma-3-4B's group of 2
# Each request: (context length, tokens scheduled now, image spans).
REQS = [(40, 40, [(3, 14), (17, 35)]),   # two spans across work items
        (60, 20, [(30, 52)]),            # a chunk; the span began before
        (25, 1, []),                     # a text row (a decode token)
        (30, 12, [(20, 45)])]            # the span runs past the context
CASES = {"causal_spans": {}, "window8": {"sliding_window": 8},
         "soft_cap": {"logits_soft_cap": 5.0}}


def _case(seed=0):
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
        q=(rng.randn(sum(counts), NQ, HD) * 0.5).astype(np.float32),
        cache=(rng.randn(L, sum(pages_per) + 1, 2, KVH, PAGE, HD)
               * 0.5).astype(np.float32),
        bt=bt, qsl=np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
        seq_lens=np.asarray([c for c, _, _ in REQS], np.int32),
        tok_req=np.repeat(np.arange(R), counts).astype(np.int32),
        tok_pos=np.concatenate([np.arange(c - n, c) for c, n, _ in REQS]
                               ).astype(np.int32),
        spans=spans, R=R, T=sum(counts))


def _port(c, spans=True, **kw):
    t = torch.from_numpy
    items = build_work_items(c["qsl"][:-1], np.diff(c["qsl"]),
                             c["seq_lens"], c["R"], BLOCK_Q)
    md = AttentionMetadata(
        token_req_idx=t(c["tok_req"]), token_pos=t(c["tok_pos"]),
        slot_mapping=None, seq_lens=t(c["seq_lens"]),
        block_tables=t(c["bt"]), block_q=BLOCK_Q,
        mm_bidir_spans=t(c["spans"]) if spans else None,
        **{k: t(v) for k, v in items.items()})
    return ragged_paged_attention(t(c["q"]), t(c["cache"]), LAYER, md,
                                  HD ** -0.5, **kw).numpy()


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
    kw = CASES[name]
    c = _case()
    got = _port(c, **kw)
    md = _jax_md(c)
    q = jnp.asarray(c["q"])
    kern, _ = jax_ragged_kernel(
        q, jnp.asarray(c["cache"]), md, HD ** -0.5, block_q=BLOCK_Q,
        chunk_pages=1, interpret=True, layer_idx=LAYER, **kw)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=0, atol=ATOL)
    ref = jax_ref_ragged(q, jnp.asarray(c["cache"][LAYER]), md, HD ** -0.5,
                         **kw)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)
    # The spans move the outputs of their rows and of no other.
    causal = _port(c, spans=False, **kw)
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
