"""fp16 queries in the port's four paged-attention wrappers and through
``LLM.generate``, against the JAX package in fp16 on the same numpy inputs
(the CUDA kernels' fp16 instances run only on the card, where
``chip_smoke.py`` phases 2, 28 and 29 hold them against these plain
versions):

- the plain versions of the ragged (mixed, chunked, sliding window, soft
  cap, ALiBi), window (with and without the cascade's init state), decode
  (ALiBi) and shared-prefix (S = 0, 64, 1000) wrappers on fp16, e4m3 and
  e5m2 caches, against the Pallas kernels in interpret mode and the JAX
  oracles, both run in fp16. Tolerances: the port's plain versions compute
  in fp32 and round the output to fp16 once; the Pallas kernels take both
  products on fp16 operands (P rounded to fp16) and the oracles round at
  their own points, so outputs of magnitude below 1 differ by a few fp16
  ulps (2^-11 = 4.9e-4 at 1): atol 2e-3 (measured 4.9e-4 on ragged
  "mixed"). The window kernel rounds the tail's P to the tails' dtype (e4m3
  beside an e4m3 cache, bf16 beside e5m2), as ``test_torch_fp8.py``'s
  ``test_window_fp8`` states: 5e-3 there. The shared pass's state is fp32:
  acc and l rtol 2e-3 (P in fp16 in the kernel), m 1e-3;
- the routing: fp16 takes the tensor-core instances at head_dim 64, 128
  and 256 and fits an H100's shared memory on every cache; fp16 at MLA's
  head_dim 576 takes the MLA instances (``test_torch_fp16_moe_mla.py``
  holds them); fp16 with image spans takes the fp16 span instances
  (``ragged_route``: ``csrc/ragged_spans_f16.cu`` at head_dim 64, 128 and
  256, the MLA option instances at 576, the scalar one elsewhere), on a
  CUDA device as on the CPU; the grouped GEMM takes the attention
  kernels' dtype codes, fp16 among them, and the quantized GEMMs take fp16
  (``test_torch_fp16_gemm.py``);
- ``LLM.generate`` in fp16 against ``aphrodite_tpu.LLM`` in fp16 on the
  same weights (the JAX engine's tree through ``params_from_jax``): a tiny
  Llama with chunked prefill, decode windows and a shared prompt (the
  cascade), on fp16, e4m3 and e5m2 caches, and a tiny BLOOM (ALiBi, the
  decode kernel's plain version). Greedy tokens identical but, on the fp8
  caches, at ties below ``TIE`` (``test_torch_fp8_llm.py``'s rule, pinned
  in ``TIES``); chosen logprobs within ``LOGPROB_ATOL`` where the tokens
  agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.attention.backend import (
    ref_ragged_paged_attention as jax_ref_ragged)
from aphrodite_tpu.attention.metadata import AttentionMetadata as JaxMD
from aphrodite_tpu.entrypoints.llm import LLM as JaxLLM
from aphrodite_tpu.ops import cascade_attention as jcascade
from aphrodite_tpu.ops.decode_paged_attention import (
    decode_paged_attention as jax_decode_kernel)
from aphrodite_tpu.ops.ragged_paged_attention import (
    ragged_paged_attention as jax_ragged_kernel)
from aphrodite_tpu.ops.window_decode_attention import (
    ref_window_decode_attention as jax_ref_window)
from aphrodite_tpu.ops.window_decode_attention import (
    window_decode_attention as jax_window_kernel)
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.attention.backend import alibi_slopes
from aphrodite_tpu_torch.loader.weights import params_from_jax
from aphrodite_tpu_torch.ops import cascade_attention as cascade
from aphrodite_tpu_torch.ops import grouped_matmul as gm
from aphrodite_tpu_torch.ops import quant_matmul as qm
from aphrodite_tpu_torch.ops import w4_wgmma as w
from aphrodite_tpu_torch.ops.cuda_build import (GEMM_DTYPE_CODES,
                                             H100_SMEM_OPTIN)
from aphrodite_tpu_torch.ops.decode_paged_attention import (
    decode_launch_geometry, decode_paged_attention)
from aphrodite_tpu_torch.ops.ragged_paged_attention import (
    DTYPE_CODES, ragged_paged_attention, ragged_route, ragged_uses_mla,
    ragged_uses_tensor_cores, ragged_work_item_tokens)
from aphrodite_tpu_torch.ops.window_decode_attention import (
    tail_dtype, window_decode_attention, window_launch_geometry,
    window_uses_tensor_cores)
from tests.test_torch_attention import (KVH, LAYER, NQ, PAGE, RAGGED_CASES,
                                        _jax_md, _ragged_case)
from tests.test_torch_flexible import family_config, perturb
from tests.test_torch_fp8 import _port_md, to_torch
from tests.test_torch_fp8_llm import _margin, assert_tokens_match

# The JAX oracles under jit, as the JAX package runs them (eager, each of
# their jnp ops compiles on its own: most of these tests' time).
jax_ref_ragged = jax.jit(jax_ref_ragged, static_argnames=(
    "scale", "sliding_window", "logits_soft_cap", "chunk_attn",
    "blocksparse"))
jax_ref_window = jax.jit(jax_ref_window, static_argnames=(
    "scale", "sliding_window", "chunk_attn", "logits_soft_cap"))

T = torch.from_numpy
ATOL = 2e-3
TAIL_ATOL = 5e-3  # the window kernel's tail P in the tails' dtype
L = 2
# Caches: q's own dtype (fp16), e4m3fn and e5m2.
CACHES = {"fp16": (jnp.float16, torch.float16),
          "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
          "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}


def _cache(cache: np.ndarray, kind: str):
    """A float32 numpy cache in ``kind`` for both packages, bit for bit."""
    jc = jnp.asarray(cache).astype(CACHES[kind][0])
    return jc, to_torch(jc)


def _f16(a: np.ndarray):
    return jnp.asarray(a.astype(np.float16)), T(a.astype(np.float16))


def _close(got: torch.Tensor, want, atol=ATOL):
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


# ------------------------------------------------------------ ragged
F16_RAGGED = dict(RAGGED_CASES, alibi=(RAGGED_CASES["mixed"][0], {}))
# The ragged cases on each cache: all on fp16, one on each fp8 cache
# (each run compiles a Pallas kernel: the file stays near 40 s).
RAGGED_RUNS = ([(n, "fp16") for n in sorted(F16_RAGGED)]
               + [("mixed", "e4m3"), ("alibi", "e5m2")])


@pytest.mark.parametrize("name,kind", RAGGED_RUNS)
def test_ragged_fp16_vs_jax_kernel_and_oracle(name, kind):
    reqs, kw = F16_RAGGED[name]
    c = _ragged_case(reqs)
    jc, tc = _cache(c["cache"], kind)
    jq, tq = _f16(c["q"])
    hd = c["q"].shape[-1]
    slopes = alibi_slopes(NQ) if name == "alibi" else None
    got = ragged_paged_attention(tq, tc, LAYER, _port_md(c), hd ** -0.5,
                                 alibi=slopes, **kw)
    md = _jax_md(c)
    kern, _ = jax_ragged_kernel(
        jq, jc, md, hd ** -0.5, block_q=32, chunk_pages=2, interpret=True,
        layer_idx=LAYER, **kw,
        **({"alibi": tuple(float(s) for s in slopes)} if slopes is not None
           else {}))
    assert kern.dtype == jnp.float16
    _close(got, kern)
    ref = jax_ref_ragged(jq, jc[LAYER], md, hd ** -0.5, **kw,
                         **({"alibi": jnp.asarray(slopes.numpy())}
                            if slopes is not None else {}))
    _close(got, ref)


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


# ------------------------------------------------------------ routing
@pytest.mark.parametrize("hd", [64, 128, 256] + [
    hd for hd in range(16, 257, 16) if hd not in (64, 128, 256)])
def test_fp16_takes_the_tensor_core_instances(hd):
    f16 = torch.float16
    assert DTYPE_CODES[f16] == 2
    assert ragged_uses_tensor_cores(f16, hd)
    for kv in (None, torch.float8_e4m3fn, torch.float8_e5m2):
        fp8 = kv is not None
        for group in (1, 4, 16, 18, 71, 128):
            tc, _, smem = window_launch_geometry(f16, group, hd,
                                                 H100_SMEM_OPTIN, fp8)
            # The window keeps its gate: head dims 64, 128 and 256, groups
            # up to one 16-row mma tile.
            assert tc == window_uses_tensor_cores(f16, group, hd) == (
                hd in (64, 128, 256) and group <= 16)
            assert smem <= H100_SMEM_OPTIN
            tc, _, smem = decode_launch_geometry(f16, group, hd,
                                                 H100_SMEM_OPTIN, kv)
            assert tc and smem <= H100_SMEM_OPTIN
            rows = 128 if hd <= 128 else 64
            if group <= rows:
                assert ragged_work_item_tokens(
                    f16, group, hd, H100_SMEM_OPTIN, kv) == rows // group
        plan = cascade.shared_prefix_plan(f16, 32, 32, 32, hd, 1024, "cpu",
                                          kv)
        assert plan.tensor_cores == (hd in (64, 128, 256))
        assert plan.smem <= H100_SMEM_OPTIN
    # fp32, and fp16 at a head_dim that is not a multiple of 16, take the
    # scalar and CUDA-core instances.
    for dt, d in ((torch.float32, hd), (f16, hd + 8)):
        assert not ragged_uses_tensor_cores(dt, d)
        assert not decode_launch_geometry(dt, 4, d, H100_SMEM_OPTIN)[0]


def test_fp16_mla_and_spans_raise_on_cuda_only():
    # Neither raises any more, on a CUDA device or elsewhere: fp16 at the
    # MLA geometry runs the MLA instances' fp16 ones, and fp16 with image
    # spans the fp16 span instances (the tensor-core ones at every head_dim
    # that is a multiple of 16 up to 256, with or without ALiBi; the MLA
    # option instances at 576; the scalar instance elsewhere), each beside
    # its bf16 self.
    f16, b16 = torch.float16, torch.bfloat16
    assert ragged_uses_mla(f16, 576)
    for hd in (64, 128, 256):
        for alibi in (False, True):
            assert ragged_route(f16, hd, True, alibi) == (
                "ragged_spans_f16", "rpa_tc_spans_f16_launch",
                "tensor_cores")
            assert ragged_route(b16, hd, True, alibi) == (
                "ragged_spans", "rpa_tc_spans_launch", "tensor_cores")
        assert ragged_route(f16, hd, False, False)[0] == "ragged_f16"
    assert ragged_route(f16, 576, True, False) == (
        "mla_opts_f16", "mla_ragged_opts_f16_launch", "mla")
    assert ragged_route(f16, 576, False, False) == (
        "mla_attention_f16", "mla_ragged_f16_launch", "mla")
    assert ragged_route(f16, 32, True, True) == (
        "ragged_spans_f16", "rpa_tc_spans_f16_launch", "tensor_cores")
    assert ragged_route(f16, 40, True, True) == (
        "ragged_paged_attention", "rpa_launch", "scalar")


def test_gemm_wrappers_refuse_fp16_naming_the_roadmap(monkeypatch):
    # No GEMM wrapper refuses fp16 any more. The grouped GEMM takes the
    # attention kernels' codes (fp32 0, bf16 1, fp16 2): fp16 passes its
    # dtype check and meets the kernel's own constraint (K and N multiples
    # of 8) before any launch. ``GEMM_DTYPE_CODES`` serves the CUDA-core
    # quantized kernels alone: fp32. The quantized wrappers send fp16 to
    # w4_wgmma's fp16 instances (its own codes; the attention kernels'
    # fp16 code, 2).
    assert gm.DTYPE_CODES is DTYPE_CODES
    assert gm.DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1,
                              torch.float16: 2}
    for table in (qm.DTYPE_CODES, GEMM_DTYPE_CODES):
        assert table == {torch.float32: 0}
    assert w.DTYPE_CODES == {torch.bfloat16: 1, torch.float16: 2}
    meta = dict(device="meta")
    x = torch.empty((4, 60), dtype=torch.float16, **meta)
    with pytest.raises(ValueError, match="multiples of 8"):
        gm.grouped_matmul(x, torch.empty((2, 60, 32), dtype=torch.float16,
                                         **meta),
                          torch.empty(3, dtype=torch.int32, **meta))
    x = torch.empty((4, 64), dtype=torch.float16, **meta)
    q = torch.empty((64, 32), dtype=torch.int8, **meta)
    s = torch.empty(32, dtype=torch.float32, **meta)
    assert w.check("w8", x, q, s, None) == 64
    routed = []
    monkeypatch.setattr(w, "matmul", lambda layout, x, *a, **kw: (
        routed.append((layout, x.dtype))
        or torch.empty((x.shape[0], 32), dtype=x.dtype, **meta)))
    assert qm.w8a16_matmul(x, q, s).dtype == torch.float16
    assert routed == [("w8", torch.float16)]


# ------------------------------------------------------- LLM.generate
TIE = 5e-2
# Where the tokens may part, at ties below TIE (test_torch_fp8_llm.py's
# rule): the counts observed, per case.
TIES = {"llama-fp16": 0, "llama-e4m3": 0, "llama-e5m2": 0, "bloom-fp16": 0}
# Chosen logprobs, the port against the JAX engine where the tokens agree:
# both engines run fp16 weights and activations with roundings at their
# own points (XLA's and PyTorch's CPU products). Measured: 7e-4 on the
# Llama, 2.9e-2 on BLOOM, whose weights redrawn at 3x fan-in scale give
# logits of tens, where one fp16 ulp is 8e-3 to 1.6e-2.
LOGPROB_ATOL = 5e-2
LLM_CASES = {"llama-fp16": ("llama", "auto"),
             "llama-e4m3": ("llama", "fp8_e4m3"),
             "llama-e5m2": ("llama", "fp8_e5m2"),
             "bloom-fp16": ("bloom", "auto")}
LLAMA = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=2, num_key_value_heads=1,
             intermediate_size=256, max_position_embeddings=512,
             rms_norm_eps=1e-5, tie_word_embeddings=False,
             architectures=["LlamaForCausalLM"])
MAX_TOKENS = 10


def _kwargs(model, kv, port=False):
    if model == "llama":  # 48-token chunks over a 5-page shared prompt
        from transformers import LlamaConfig
        kw = dict(hf_config=LlamaConfig(**LLAMA), block_size=16,
                  num_kv_blocks=128, max_num_seqs=4, max_num_batched_tokens=48,
                  max_model_len=256)
    else:
        kw = dict(hf_config=family_config("bloom"), block_size=16,
                  num_kv_blocks=64, max_num_seqs=4,
                  max_num_batched_tokens=16, max_model_len=128,
                  **({"decode_window": 8} if port else {}))
    return dict(kw, tokenizer="unused", dtype="float16", load_format="dummy",
                device="cpu", kv_cache_dtype=kv,
                **({} if port else {"async_scheduling": False}))


def _prompts(model):
    rng = np.random.RandomState(0)
    if model == "llama":
        shared = rng.randint(1, 250, size=80).tolist()   # 5 whole pages
        return [shared + rng.randint(1, 250, size=n).tolist()
                for n in (3, 17, 40)]
    return [rng.randint(1, 250, size=n).tolist() for n in (5, 40, 23)]


def _chosen(outs):
    return ([o.outputs[0].token_ids for o in outs],
            [[lp[t].logprob for t, lp in zip(o.outputs[0].token_ids,
                                              o.outputs[0].logprobs)]
             for o in outs])


@pytest.mark.parametrize("case", sorted(LLM_CASES))
def test_fp16_greedy_tokens_match_jax(case, monkeypatch):
    model, kv = LLM_CASES[case]
    jax_llm = JaxLLM("dummy", **_kwargs(model, kv))
    worker = jax_llm.engine.core.worker
    if model == "bloom":
        tree = perturb(worker.params, 11)
        worker.params = worker.runner.params = jax.tree.map(jnp.asarray,
                                                            tree)
    tree = worker.params
    prompts = _prompts(model)
    outs = jax_llm.generate(prompts, JaxParams(
        temperature=0.0, max_tokens=MAX_TOKENS, ignore_eos=True,
        logprobs=2))
    want, want_lp = _chosen(outs)
    margins = [[_margin(s) for s in o.outputs[0].logprobs] for o in outs]
    port = LLM("dummy", **_kwargs(model, kv, port=True))
    port.engine.core.worker.load_params(params_from_jax(tree))
    runner = port.engine.core.worker.runner
    assert runner.kv_cache.dtype == {
        "auto": torch.float16, "fp8_e4m3": torch.float8_e4m3fn,
        "fp8_e5m2": torch.float8_e5m2}[kv]
    passes = []
    spa = cascade.shared_prefix_attention
    monkeypatch.setattr(
        "aphrodite_tpu_torch.attention.backend.shared_prefix_attention",
        lambda *a: passes.append(a[4]) or spa(*a))
    got, got_lp = _chosen(port.generate(prompts, SamplingParams(
        temperature=0.0, max_tokens=MAX_TOKENS, ignore_eos=True,
        logprobs=1)))
    if model == "llama":
        assert passes and set(passes) == {80}  # the cascade branch ran
    assert len({t for x in want for t in x}) > 5  # the tokens vary
    gaps = [abs(a - b) for wt, gt, wl, gl in zip(want, got, want_lp, got_lp)
            for i, (a, b) in enumerate(zip(wl, gl)) if wt[:i + 1]
            == gt[:i + 1]]
    assert max(gaps) <= LOGPROB_ATOL, max(gaps)
    assert_tokens_match(port, prompts, want, margins, got, TIES[case])
