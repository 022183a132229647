"""fp16 queries in the port's ragged wrapper and the routing of every
fp16 kernel, against the JAX package in fp16 on the same numpy inputs
(the CUDA kernels' fp16 instances run only on the card, where
``chip_smoke.py`` phases 2, 28 and 29 hold them against these plain
versions). The window, decode and shared-prefix wrappers are in
``test_torch_fp16_decode.py``, ``LLM.generate`` in
``test_torch_fp16_llm.py`` (three files that the Tier-1 workers spread).

- the plain version of the ragged wrapper (mixed, chunked, sliding
  window, soft cap, ALiBi) on fp16, e4m3 and e5m2 caches, against the
  Pallas kernel in interpret mode and the JAX oracle, both run in fp16.
  Tolerances: the port's plain versions compute in fp32 and round the
  output to fp16 once; the Pallas kernels take both products on fp16
  operands (P rounded to fp16) and the oracles round at their own points,
  so outputs of magnitude below 1 differ by a few fp16 ulps (2^-11 =
  4.9e-4 at 1): atol 2e-3 (measured 4.9e-4 on ragged "mixed");
- the routing: fp16 takes the tensor-core instances at head_dim 64, 128
  and 256 and fits an H100's shared memory on every cache; fp16 at MLA's
  head_dim 576 takes the MLA instances (``test_torch_fp16_moe_mla.py``
  holds them); fp16 with image spans takes the fp16 span instances
  (``ragged_route``: ``csrc/ragged_spans_f16.cu`` at head_dim 64, 128 and
  256, the MLA option instances at 576, the scalar one elsewhere), on a
  CUDA device as on the CPU; the grouped GEMM takes the attention
  kernels' dtype codes, fp16 among them, and the quantized GEMMs take fp16
  (``test_torch_fp16_gemm.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.attention.backend import (
    ref_ragged_paged_attention as jax_ref_ragged)
from aphrodite_tpu.ops.ragged_paged_attention import (
    ragged_paged_attention as jax_ragged_kernel)
from aphrodite_tpu_torch.attention.backend import alibi_slopes
from aphrodite_tpu_torch.ops import cascade_attention as cascade
from aphrodite_tpu_torch.ops import grouped_matmul as gm
from aphrodite_tpu_torch.ops import quant_matmul as qm
from aphrodite_tpu_torch.ops import w4_wgmma as w
from aphrodite_tpu_torch.ops.cuda_build import (GEMM_DTYPE_CODES,
                                             H100_SMEM_OPTIN)
from aphrodite_tpu_torch.ops.decode_paged_attention import (
    decode_launch_geometry)
from aphrodite_tpu_torch.ops.ragged_paged_attention import (
    DTYPE_CODES, ragged_paged_attention, ragged_route, ragged_uses_mla,
    ragged_uses_tensor_cores, ragged_work_item_tokens)
from aphrodite_tpu_torch.ops.window_decode_attention import (
    window_launch_geometry, window_uses_tensor_cores)
from tests.test_torch_attention import (LAYER, NQ, RAGGED_CASES, _jax_md,
                                        _ragged_case)
from tests.test_torch_fp8 import _port_md, to_torch

# The JAX oracle under jit (eager, each of its jnp ops compiles on its
# own: most of these tests' time); test_torch_fp16_decode.py reuses it.
jax_ref_ragged = jax.jit(jax_ref_ragged, static_argnames=(
    "scale", "sliding_window", "logits_soft_cap", "chunk_attn",
    "blocksparse"))

T = torch.from_numpy
ATOL = 2e-3
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
