"""ALiBi in the port: the head slopes of both rules (the standard one of
BLOOM, Falcon-rw and Baichuan; MPT's interleave) against the JAX package's
bit for bit, and the ragged attention's plain version with ALiBi (which the
CUDA wrapper runs on CPU tensors) against the JAX package's Pallas kernel
in interpret mode, on the same numpy inputs: groups of 1, 4 and 8 query
heads a KV head at head counts that are not powers of two, a mixed wave
with chunked prefill (queries at positions past keys that earlier chunks
cached), and ALiBi with a soft cap; BLOOM's and MPT's head dims (80 and
112, which the card runs in 128-wide tensor-core tiles) and groups past
one 16-row mma tile (18, and Falcon-7B's 71).

ALiBi goes in before the soft cap, as the TPU kernel adds it
(``ragged_paged_attention.py:201-216``); the JAX oracle adds it after
(``attention/backend.py:170-178``), so the oracle is held (at group 4) only
where there is no cap. Tolerance: fp32, atol 1e-5 (the one
``tests/test_torch_decode_attention.py`` states: online softmax chunk by
chunk in the kernel, one softmax in the plain version)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.attention.backend import alibi_slopes as jax_slopes
from aphrodite_tpu.attention.backend import (
    ref_ragged_paged_attention as jax_ref_ragged)
from aphrodite_tpu.attention.metadata import AttentionMetadata as JaxMD
from aphrodite_tpu.attention.metadata import build_work_items as jax_items
from aphrodite_tpu.models.llama_variants import MPTForCausalLM as JaxMPT
from aphrodite_tpu.ops.ragged_paged_attention import (
    ragged_paged_attention as jax_ragged_kernel)
from aphrodite_tpu_torch.attention.backend import alibi_slopes
from aphrodite_tpu_torch.attention.metadata import (AttentionMetadata,
                                                    build_work_items)
from aphrodite_tpu_torch.models.llama_variants import MPTForCausalLM
from aphrodite_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention)

# The JAX oracles under jit, as the JAX package runs them (eager, each of
# their jnp ops compiles on its own: most of these tests' time).
jax_ref_ragged = jax.jit(jax_ref_ragged, static_argnames=(
    "scale", "sliding_window", "logits_soft_cap", "chunk_attn",
    "blocksparse"))

ATOL = 1e-5
PAGE, L, LAYER, HD, BLOCK_Q = 16, 2, 1, 32, 16


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    assert x.dtype == np.float32
    return x.view(np.uint32)


@pytest.mark.parametrize("rule", ["standard", "mpt_bias_max_8",
                                  "mpt_bias_max_16"])
def test_slopes_equal_jax_bit_for_bit(rule):
    for n in range(1, 65):
        if rule == "standard":
            got, want = alibi_slopes(n).numpy(), jax_slopes(n)
        else:
            bias_max = int(rule.rsplit("_", 1)[1])
            got = MPTForCausalLM.mpt_slopes(n, bias_max).numpy()
            want = JaxMPT._mpt_slopes(n, bias_max)
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=n)


# (query heads, KV heads): groups 1, 4 and 8, none a power of two; 18
# and 71 on one KV head.
GEOMETRIES = {"group1": (3, 3), "group4": (12, 3), "group8": (24, 3),
              "group18": (18, 1), "group71": (71, 1)}
# Each request: (context length, tokens scheduled now). A prefill, a later
# chunk of a longer prompt, and a decode row; one work item each.
REQS = [(12, 12), (60, 14), (25, 1)]


def _case(nq, kvh, seed=0, hd=HD):
    rng = np.random.RandomState(seed)
    R = len(REQS)
    pages_per = [-(-c // PAGE) for c, _ in REQS]
    bt = np.zeros((R, max(pages_per) + 1), np.int32)
    perm = rng.permutation(np.arange(1, sum(pages_per) + 1))
    o = 0
    for r, n in enumerate(pages_per):
        bt[r, :n] = perm[o:o + n]
        o += n
    counts = [n for _, n in REQS]
    qsl = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    seq_lens = np.asarray([c for c, _ in REQS], np.int32)
    tok_req = np.repeat(np.arange(R), counts).astype(np.int32)
    tok_pos = np.concatenate([np.arange(c - n, c) for c, n in REQS]
                             ).astype(np.int32)
    cache = (rng.randn(L, sum(pages_per) + 1, 2, kvh, PAGE, hd)
             * 0.5).astype(np.float32)
    q = (rng.randn(len(tok_pos), nq, hd) * 0.5).astype(np.float32)
    return dict(q=q, cache=cache, bt=bt, qsl=qsl, seq_lens=seq_lens,
                tok_req=tok_req, tok_pos=tok_pos, R=R, T=len(tok_pos))


def _port(c, slopes, **kw):
    t = torch.from_numpy
    items = build_work_items(c["qsl"][:-1], np.diff(c["qsl"]),
                             c["seq_lens"], c["R"], BLOCK_Q)
    md = AttentionMetadata(
        token_req_idx=t(c["tok_req"]), token_pos=t(c["tok_pos"]),
        slot_mapping=None, seq_lens=t(c["seq_lens"]),
        block_tables=t(c["bt"]), block_q=BLOCK_Q,
        **{k: t(v) for k, v in items.items()})
    hd = c["q"].shape[-1]
    return ragged_paged_attention(t(c["q"]), t(c["cache"]), LAYER, md,
                                  hd ** -0.5, alibi=slopes, **kw).numpy()


def _jax_md(c):
    md = JaxMD(
        token_req_idx=jnp.asarray(c["tok_req"]),
        token_pos=jnp.asarray(c["tok_pos"]),
        slot_mapping=jnp.zeros(c["T"], jnp.int32),
        query_start_loc=jnp.asarray(c["qsl"]),
        seq_lens=jnp.asarray(c["seq_lens"]),
        block_tables=jnp.asarray(c["bt"]),
        num_reqs=jnp.asarray(c["R"], jnp.int32),
        num_tokens=jnp.asarray(c["T"], jnp.int32))
    items = jax_items(c["qsl"][:-1], np.diff(c["qsl"]), c["seq_lens"],
                      c["R"], c["T"], BLOCK_Q, c["R"])
    return dataclasses.replace(
        md, **{k: jnp.asarray(v) for k, v in items.items()})


# name: (geometry, options, head_dim).
CASES = {
    "group1": ("group1", {}, HD),
    "group4": ("group4", {}, HD),
    "group8": ("group8", {}, HD),
    "group4_soft_cap": ("group4", {"logits_soft_cap": 5.0}, HD),
    "group4_hd80": ("group4", {}, 80),     # BLOOM-3b's head
    "group4_hd112": ("group4", {}, 112),   # MPT-30B's
    "group18": ("group18", {}, HD),
    "group71": ("group71", {}, 64),        # Falcon-7B's group and head
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ragged_alibi_vs_pallas_interpret(name):
    geom, kw, hd = CASES[name]
    nq, kvh = GEOMETRIES[geom]
    c = _case(nq, kvh, hd=hd)
    slopes = alibi_slopes(nq)
    got = _port(c, slopes, **kw)
    md = _jax_md(c)
    q = jnp.asarray(c["q"])
    kern, _ = jax_ragged_kernel(
        q, jnp.asarray(c["cache"]), md, hd ** -0.5, block_q=BLOCK_Q,
        chunk_pages=1, interpret=True, layer_idx=LAYER,
        alibi=tuple(float(s) for s in slopes), **kw)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=0, atol=ATOL)
    without = _port(c, None, **kw)
    assert np.abs(got - without).max() > 0.1   # the bias moves the output
    if geom in ("group1", "group8"):
        return
    # The JAX oracle (at group 4 and past one mma tile: each new geometry
    # costs a compile): equal without a cap; with one, its order (the cap,
    # then the bias) gives another result.
    ref = jax_ref_ragged(q, jnp.asarray(c["cache"][LAYER]), md, hd ** -0.5,
                         alibi=jnp.asarray(slopes.numpy()), **kw)
    if "logits_soft_cap" not in kw:
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)
    else:
        assert np.abs(got - np.asarray(ref)).max() > 1e-3
