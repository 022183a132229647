"""fp16 in the port's grouped expert GEMM and in the MLA geometry of its
ragged and window attention, against the JAX package in fp16 on the same
numpy inputs (the CUDA instances, ``csrc/grouped_matmul_f16.cu`` and
``csrc/mla_attention_f16.cu``, run only on the card, where
``chip_smoke.py`` phases 2, 32 and 33 hold them against these plain
versions):

- the grouped GEMM's plain version in fp16 vs the reference's grouped
  product in fp16, with empty groups. megablox ``gmm`` refuses fp16
  operands (``jax/experimental/pallas/ops/tpu/megablox/common.py:51``:
  bf16 or fp32 only), so the JAX package's fp16 MoE raises on its Pallas
  route (a TPU, or ``APHRODITE_PALLAS_INTERPRET=1``) and computes on its
  XLA route, ``jax.lax.ragged_dot`` with ``preferred_element_type`` fp32
  then cast (``aphrodite_tpu/models/moe_common.py:_grouped_moe``); both
  are held here. Both sum in fp32 and round once, so the port agrees to
  one fp16 ulp of each output (rtol 2^-10) and equals the fp32 products
  rounded once, bit for bit;
- the repair check of the grouped route: the port's gate|up product on
  the fused ``w_gate_up`` rounds gate and up once each, bit for bit as two
  products would (``_grouped_moe`` runs three), and ``moe_combine``'s
  grouped route in fp16 vs ``_grouped_moe`` on its XLA route (atol 2e-3:
  both round each product to fp16; the port sums a token's k rows once,
  JAX adds them in sorted order in fp16);
- the MLA plain versions at head_dim 576 in fp16 vs the Pallas ragged and
  window kernels in interpret mode in fp16 (at the JAX runner's 640-lane
  padding, the first 576 lanes compared) on fp16, e4m3 and e5m2 caches,
  the window beside e4m3's fp8 tails, e5m2's bf16 tails and from the
  cascade's init state: atol 2e-3 where the Pallas kernels round P to
  fp16 before P V and the plain versions keep it in fp32 (outputs of
  O(0.3), where an fp16 ulp is 2.4e-4), 5e-3 on the window's fp8 and bf16
  tails, whose P the kernel rounds to the tails' dtype
  (``test_torch_fp16.py``'s ``TAIL_ATOL``);
- DeepSeek's absorbed products (``layers.linear.bmm_f32``): fp32 sums,
  one rounding, on the CPU and, where the device is not the CPU, through
  an fp32 output (a 16-bit ``torch.bmm`` on the card may reduce in 16
  bits).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.models import moe_common as jax_moe
from aphrodite_tpu.ops import cascade_attention as jcascade
from aphrodite_tpu.ops.window_decode_attention import (
    window_decode_attention as jax_window_kernel)
from aphrodite_tpu_torch.layers.linear import bmm_f32
from aphrodite_tpu_torch.models import moe_common
from aphrodite_tpu_torch.ops import cascade_attention as cascade
from aphrodite_tpu_torch.ops.grouped_matmul import (grouped_matmul,
                                                    ref_grouped_matmul)
from aphrodite_tpu_torch.ops.ragged_paged_attention import (
    mla_smem_bytes, ragged_uses_mla, ragged_work_item_tokens)
from aphrodite_tpu_torch.ops.window_decode_attention import (
    tail_dtype, window_decode_attention, window_launch_geometry,
    window_uses_mla)

from tests.test_torch_fp8 import to_torch
from tests.test_torch_mla_attention import (HD, L, LAYER, PAGE, RAGGED,
                                            _pad, _ragged_inputs, _tables)
from tests.test_torch_moe import GMM_CASES

ATOL, TAIL_ATOL = 2e-3, 5e-3
F16 = torch.float16
# Caches: q's own dtype (fp16), e4m3fn and e5m2, in both packages.
CACHES = {"fp16": (jnp.float16, torch.float16),
          "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
          "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}


def _close(got: torch.Tensor, want, atol=ATOL):
    assert got.dtype == F16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


# ------------------------------------------------------------ grouped GEMM
@pytest.mark.parametrize("name", sorted(GMM_CASES))
def test_grouped_plain_fp16_matches_ragged_dot(name):
    import jax
    from jax.experimental.pallas.ops.tpu.megablox import gmm
    sizes = np.asarray(GMM_CASES[name], np.int32)
    E, M, K, N = len(sizes), int(sizes.sum()), 48, 80
    rng = np.random.RandomState(5)
    x = rng.randn(M, K).astype(np.float16)
    w = (rng.randn(E, K, N) / np.sqrt(K)).astype(np.float16)
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    before = grouped_matmul.launches
    got = grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(off))
    assert grouped_matmul.launches == before  # CPU: the plain version
    assert got.dtype == F16
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes),
            preferred_element_type=jnp.float32, tiling=(32, K, N),
            interpret=True)
    rd = jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(sizes),
                            preferred_element_type=jnp.float32
                            ).astype(jnp.float16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(rd, np.float32), rtol=2 ** -10,
                               atol=0)
    # fp32 sums rounded once to fp16, bit for bit.
    want = torch.zeros_like(got)
    for e in range(E):
        a, b = off[e], off[e + 1]
        want[a:b] = (torch.from_numpy(x[a:b]).float()
                     @ torch.from_numpy(w[e]).float()).half()
    assert torch.equal(got, want)


def test_fused_gate_up_rounds_like_two_products():
    """The port's one product over w_gate_up [E, H, 2I] equals the
    reference's gate and up products, each rounded once to fp16, bit for
    bit: every output column is its own fp32 sum."""
    rng = np.random.RandomState(6)
    E, M, H, inter = 4, 50, 64, 40
    x = torch.from_numpy(rng.randn(M, H).astype(np.float16))
    wg, wu = (torch.from_numpy((rng.randn(E, H, inter) / 8).astype(
        np.float16)) for _ in range(2))
    off = torch.tensor([0, 12, 12, 31, 50], dtype=torch.int32)
    gu = grouped_matmul(x, torch.cat([wg, wu], dim=-1), off)
    assert torch.equal(gu[:, :inter], grouped_matmul(x, wg, off))
    assert torch.equal(gu[:, inter:], grouped_matmul(x, wu, off))


def test_grouped_moe_fp16_matches_the_reference(monkeypatch):
    """The grouped route of ``moe_combine`` in fp16 vs the JAX package's
    ``_grouped_moe`` on its XLA route (``ragged_dot``; its megablox route
    refuses fp16), on the same fp16 weights and routing: T * k = 64 rows
    over 8 experts, one expert left empty."""
    monkeypatch.delenv("APHRODITE_PALLAS_INTERPRET", raising=False)
    rng = np.random.RandomState(7)
    T, H, inter, E, k = 32, 64, 48, 8, 2
    h = (rng.randn(T, H) * 0.5).astype(np.float16)
    wg, wu = ((rng.randn(E, H, inter) / 8).astype(np.float16)
              for _ in range(2))
    wd = (rng.randn(E, inter, H) / 7).astype(np.float16)
    topi = np.stack([rng.choice(np.arange(1, E), k, replace=False)
                     for _ in range(T)]).astype(np.int32)
    topw = rng.rand(T, k).astype(np.float32)
    import jax
    want = jax_moe._grouped_moe(
        jnp.asarray(h), {"we_gate": jnp.asarray(wg),
                         "we_up": jnp.asarray(wu),
                         "we_down": jnp.asarray(wd)},
        lambda g, u: jax.nn.silu(g) * u,
        jnp.asarray(topi), jnp.asarray(topw).astype(jnp.float16), E)
    routes = []
    real = moe_common._grouped_moe
    monkeypatch.setattr(moe_common, "_grouped_moe",
                        lambda *a: routes.append(1) or real(*a))
    t = torch.from_numpy
    got = moe_common.moe_combine(t(h), torch.cat([t(wg), t(wu)], dim=-1),
                                 t(wd), t(topi).long(), t(topw))
    assert routes and got.dtype == F16
    _close(got, want)


# ---------------------------------------------------------- MLA geometry
def test_fp16_takes_the_mla_instances():
    """fp16 at head_dim 576 takes the MLA instances, on every cache, in
    the same shared memory and work items as bf16."""
    assert ragged_uses_mla(F16, HD) and window_uses_mla(F16, HD)
    for group in (16, 128):
        for kv in (None, torch.float8_e4m3fn, torch.float8_e5m2):
            assert ragged_work_item_tokens(F16, group, HD, 232448, kv) == \
                ragged_work_item_tokens(torch.bfloat16, group, HD, 232448,
                                        kv) == max(1, 64 // group)
            assert window_launch_geometry(F16, group, HD, 232448,
                                          kv is not None) == \
                (True, 16, mla_smem_bytes(kv is not None))


def _as(a: np.ndarray, kind: str):
    """``a`` in the cache dtype ``kind`` for JAX (640 lanes) and for the
    port (the same bytes' first 576 lanes)."""
    j = jnp.asarray(_pad(a)).astype(CACHES[kind][0])
    return j, to_torch(j)[..., :HD].contiguous()


# Each ragged geometry on fp16; group 16 on each fp8 cache too.
RAGGED_RUNS = [(n, "fp16") for n in sorted(RAGGED)] + [
    ("group16-mixed", "e4m3"), ("group16-mixed", "e5m2")]


@pytest.mark.parametrize("name,kind", RAGGED_RUNS)
def test_ragged_mla_fp16_vs_pallas(name, kind):
    nq, reqs = RAGGED[name]
    inp = _ragged_inputs(nq, reqs, np.random.RandomState(8))
    jc, tc = _as(inp["cache"], kind)
    jq, tq = _as(inp["q"], "fp16")
    got = inp["port"](tq, tc)
    kern = np.asarray(inp["pallas"](jq, jc), np.float32)
    assert np.asarray(inp["pallas"](jq, jc)).dtype == np.float16
    np.testing.assert_array_equal(kern[..., HD:], 0)
    _close(got, kern[..., :HD])


# (cache, the cascade's init state): fp16 with and without it, e4m3 with
# its fp8 tails, e5m2 with its bf16 tails after the cascade's state.
WINDOW_RUNS = [("fp16", False), ("fp16", True), ("e4m3", False),
               ("e5m2", True)]


@pytest.mark.parametrize("kind,cascade_init", WINDOW_RUNS)
def test_window_mla_fp16_vs_pallas(kind, cascade_init):
    rng = np.random.RandomState(9)
    nq, plens, step, kw = 16, [40, 13, 70], 2, 4
    R = len(plens)
    bt, P = _tables(rng, plens)
    jc, tc = _as((rng.randn(L, P, 2, 1, PAGE, HD) * 0.3).astype(np.float32),
                 kind)
    td = tail_dtype(CACHES[kind][1])
    assert td == {"fp16": F16, "e4m3": torch.float8_e4m3fn,
                  "e5m2": torch.bfloat16}[kind]
    jtd = {F16: jnp.float16, torch.bfloat16: jnp.bfloat16,
           torch.float8_e4m3fn: jnp.float8_e4m3fn}[td]
    jt = [jnp.asarray(_pad((rng.randn(L, R, 1, kw, HD) * 0.3).astype(
        np.float32))).astype(jtd) for _ in range(2)]
    tt = [to_torch(t)[..., :HD].contiguous() for t in jt]
    jq, tq = _as((rng.randn(R, nq, HD) * 0.3).astype(np.float32), "fp16")
    pl, scale = np.asarray(plens, np.int32), 192 ** -0.5
    extra, jextra = {}, {}
    if cascade_init:  # the first page of every request, shared
        S = PAGE
        bt = bt.copy()
        bt[:, 0] = bt[0, 0]
        pages = bt[0, :1].copy()
        init = cascade.shared_prefix_attention(
            tq, tc, LAYER, torch.from_numpy(pages), S, scale)
        extra = dict(cascade_init=init, shared_len=S)
        j_init = jcascade.shared_prefix_attention(
            jq, jc, jnp.asarray(LAYER), jnp.asarray(np.append(pages, 0)),
            jnp.asarray(S), scale, chunk_pages=1, interpret=True)
        jextra = dict(cascade_init=j_init, shared_len=jnp.asarray(S))
    t = torch.from_numpy
    got = window_decode_attention(tq, tc, tt[0], tt[1], LAYER, step, t(pl),
                                  t(bt), scale, **extra)
    kern = np.asarray(jax_window_kernel(
        jq, jc, jt[0], jt[1], jnp.int32(LAYER), jnp.int32(step),
        jnp.asarray(pl), jnp.asarray(bt), scale, chunk_pages=2,
        interpret=True, **jextra), np.float32)
    np.testing.assert_array_equal(kern[..., HD:], 0)
    _close(got, kern[..., :HD], ATOL if kind == "fp16" else TAIL_ATOL)


# ---------------------------------------------------- absorbed products
def test_absorbed_products_sum_in_fp32_and_round_once(monkeypatch):
    rng = np.random.RandomState(10)
    a = torch.from_numpy(rng.randn(4, 30, 128).astype(np.float16))
    b = torch.from_numpy((rng.randn(4, 128, 64) / 11).astype(np.float16))
    got = bmm_f32(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.bmm(a.float(), b.float()))
    # Off the CPU the product asks for fp32 output of the 16-bit operands
    # (the meta device stands for the card here).
    calls = []
    real = torch.bmm

    def spy(x, y, **kw):
        calls.append((x.dtype, y.dtype, kw.get("out_dtype")))
        return real(x, y, **kw)
    monkeypatch.setattr(torch, "bmm", spy)
    out = bmm_f32(a.to("meta"), b.to("meta"))
    assert out.dtype == torch.float32 and out.shape == (4, 30, 64)
    assert calls == [(F16, F16, torch.float32)]
