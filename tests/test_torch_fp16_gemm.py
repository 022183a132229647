"""fp16 activations in the port's quantized decode GEMMs, against the JAX
package in fp16 on the same numpy inputs (the CUDA kernel's fp16
instances, ``csrc/w4_wgmma_f16.cu``, run only on the card, where
``chip_smoke.py`` phases 2, 30 and 31 hold them against these plain
versions):

- the five plain versions (``ref_w8a16_matmul``, ``ref_w4a16_matmul``,
  ``ref_w4a16_packed_matmul``, ``ref_w4a16_int4_matmul``,
  ``ref_fp8_matmul`` with and without W8A8 row scales) in fp16 against the
  four Pallas kernels in interpret mode and ``aphrodite_tpu.ops.
  quant_gemm.fp8_matmul``, all run in fp16. Tolerances, in fp16 ulps of
  the output's largest magnitude (``ulp16``: 2^-10 of its power of two):
  the plain versions compute in fp32 and round once, so they lie within 1
  ulp of the float64 product; the Pallas W4 kernels round the scaled
  weights, the zero term and the group sums of x to fp16
  (``quant_matmul_pallas.py:100-110, 185-194``; one ulp, 7.8e-3, was seen
  at outputs of 8.5), so the two are held within 4 ulps of each other;
- ``fold_model``, the kernel's arithmetic, on fp16 x (both forms of the
  zero, forced K splits) against the plain versions (fp32 both, 1e-5 of
  the scale);
- the kernel's fp16 conversions, bit for bit: every int8 byte, every
  finite e4m3 byte (against the format's definition) and every nibble
  less every zero that ``zeros_integral`` admits for fp16 (and for bf16),
  the bound tight on both sides; ``plan``, ``schedule`` and the shared
  memory the same for bf16 and fp16, whose launches differ only in the
  dtype code and the entry;
- the routing, on ``meta`` tensors: each of the five wrappers sends fp16
  to ``w4_wgmma.matmul`` with its layout and counts an fp16 launch; a
  bf16 and an fp16 call on one weight at one M prepare two launches (the
  prepared-launch key holds x's dtype);
- ``LLM.generate`` in fp16 with ``quantization=`` gptq (an unpacked and a
  packed geometry), awq, w8a16, fp8, fp8_w8a8 and int8 against
  ``aphrodite_tpu.LLM`` in fp16 on the same tree: greedy tokens identical
  but, where activations round to 8 bits, at ties below 5e-2
  (``test_torch_fp8_llm.py``'s ``TIE`` rule), as many as ``TIES`` pins.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.entrypoints.llm import LLM as JaxLLM
from aphrodite_tpu.ops import quant_gemm as jgemm
from aphrodite_tpu.ops.quant_matmul_pallas import (
    w4a16_int4_matmul_pallas, w4a16_matmul_pallas,
    w4a16_packed_matmul_pallas, w8a16_matmul_pallas)
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.loader.weights import params_from_jax
from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops import quant_gemm
from aphrodite_tpu_torch.ops import quant_matmul as qm
from aphrodite_tpu_torch.ops import w4_wgmma as w
from tests.test_torch_fp8_llm import _margin, assert_tokens_match

T = torch.from_numpy
F16, B16 = torch.float16, torch.bfloat16
W4_LAYOUTS = ("uint4", "packed", "int4")


def ulp16(v: float) -> float:
    """fp16's ulp at magnitude v (v >= 2^-14)."""
    return 2.0 ** (np.floor(np.log2(v)) - 10)


def _packed(q: np.ndarray) -> torch.Tensor:
    """uint4 [K, N] as packed bytes [K/2, N]: row r low, r + K/2 high."""
    K = q.shape[0]
    return T(q[:K // 2].astype(np.uint8) | (q[K // 2:].astype(np.uint8) << 4))


def _inputs(layout, M, K, N, group, seed):
    """fp16 x and one layout's weights as numpy: q int8 [K, N] (uint4,
    int4's signed q - 8, or int8), fp8 as uint8 e4m3 bytes; s, z fp32 (z
    None for w8 and fp8). Outputs of some tens."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float16)
    if layout == "w8":
        q = rng.integers(-128, 128, size=(K, N)).astype(np.int8)
        return x, q, rng.uniform(0.5, 1.5, N).astype(np.float32) / 400, None
    if layout == "fp8":
        v = torch.from_numpy(64 * rng.normal(size=(K, N)).astype(np.float32))
        q = v.clamp(-448, 448).to(torch.float8_e4m3fn).view(torch.uint8)
        return x, q.numpy(), rng.uniform(0.5, 1.5, N).astype(
            np.float32) / 400, None
    G = K // group
    lo = -8 if layout == "int4" else 0
    q = rng.integers(lo, lo + 16, size=(K, N)).astype(np.int8)
    z = rng.integers(lo, lo + 16, size=(G, N)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, size=(G, N)).astype(np.float32) / 10
    return x, q, s, z


def _weights(layout, q, s, z):
    """The port's weight arguments of ``layout`` (torch)."""
    if layout == "w8":
        return T(q), T(s)
    if layout == "fp8":
        return T(q).view(torch.float8_e4m3fn), T(s)
    qt = {"uint4": lambda: T(q), "packed": lambda: _packed(q),
          "int4": lambda: qm.pack_int4(T(q))}[layout]()
    return qt, T(s), T(z)


WRAPPERS = {"w8": qm.w8a16_matmul, "fp8": qm.fp8_matmul,
            "uint4": qm.w4a16_matmul, "packed": qm.w4a16_packed_matmul,
            "int4": qm.w4a16_int4_matmul}


def _exact(layout, x, q, s, z, rs=None):
    """The float64 product of the same weights and x."""
    xd = x.astype(np.float64)
    if layout in ("w8", "fp8"):
        wq = (T(q).view(torch.float8_e4m3fn).double().numpy()
              if layout == "fp8" else q.astype(np.float64))
        y = xd @ wq
        if rs is not None:
            y = y * rs.astype(np.float64)[:, None]
        return y * s.astype(np.float64)
    K, N = q.shape
    G = s.shape[0]
    wd = ((q.astype(np.float64).reshape(G, K // G, N) - z[:, None])
          * s[:, None]).reshape(K, N)
    return xd @ wd


def _pallas(layout, x, q, s, z):
    """The JAX package's Pallas kernel of ``layout`` in interpret mode, fp16
    x (so fp16 out)."""
    xj = jnp.asarray(x)
    if layout == "w8":
        y = w8a16_matmul_pallas(xj, jnp.asarray(q), jnp.asarray(s),
                                block_n=128, block_k=512, interpret=True)
    elif layout == "uint4":
        y = w4a16_matmul_pallas(xj, jnp.asarray(q), jnp.asarray(s),
                                jnp.asarray(z), block_n=128, block_k=512,
                                interpret=True)
    elif layout == "packed":
        y = w4a16_packed_matmul_pallas(
            xj, jnp.asarray(_packed(q).numpy().view(np.int8)),
            jnp.asarray(s), jnp.asarray(z), block_k=q.shape[0] // 2,
            block_n=128, interpret=True)
    else:
        y = w4a16_int4_matmul_pallas(
            xj, jnp.asarray(q).astype(jnp.int4), jnp.asarray(s),
            jnp.asarray(z), block_n=128, block_k=512, interpret=True)
    assert y.dtype == jnp.float16
    return np.asarray(y).astype(np.float64)


# (M, K, N, group): the packed kernel takes K/2 a multiple of 8 groups.
PALLAS_CASES = {"w8": (8, 512, 256, 512), "uint4": (8, 512, 256, 128),
                "packed": (8, 512, 256, 32), "int4": (5, 512, 256, 64)}


@pytest.mark.parametrize("layout", sorted(PALLAS_CASES))
def test_plain_fp16_vs_pallas_interpret(layout):
    M, K, N, group = PALLAS_CASES[layout]
    x, q, s, z = _inputs(layout, M, K, N, group, seed=K + N + group)
    got = WRAPPERS[layout](T(x), *_weights(layout, q, s, z))
    assert got.dtype == F16
    got = got.double().numpy()
    exact = _exact(layout, x, q, s, z)
    ulp = ulp16(np.abs(exact).max())
    assert np.abs(exact).max() > 8.0  # fp16 ulps of 2^-7 and more
    np.testing.assert_allclose(got, exact, rtol=0, atol=ulp)
    np.testing.assert_allclose(got, _pallas(layout, x, q, s, z), rtol=0,
                               atol=4 * ulp)


@pytest.mark.parametrize("act_quant", [False, True])
def test_plain_fp8_fp16_vs_jax(act_quant):
    # quant_gemm.fp8_matmul (M <= 256: qm.fp8_matmul's plain version on
    # CPU tensors, with the per-token e4m3 rounding for W8A8) against the
    # JAX function, both in fp16.
    M, K, N = 7, 512, 256
    x, q, s, _ = _inputs("fp8", M, K, N, K, seed=3)
    q8 = T(q).view(torch.float8_e4m3fn)
    got = quant_gemm.fp8_matmul(T(x), q8, T(s), act_quant=act_quant)
    assert got.dtype == F16
    import ml_dtypes
    want = np.asarray(jgemm.fp8_matmul(
        jnp.asarray(x), jnp.asarray(q.view(ml_dtypes.float8_e4m3fn)),
        jnp.asarray(s), act_quant=act_quant)).astype(np.float64)
    if act_quant:
        x8, xs = quant_gemm.fp8_quantize_rows(T(x))
        assert x8.dtype == F16  # e4m3 values held in fp16, exact
        exact = _exact("fp8", x8.double().numpy(), q, s, None,
                       xs.reshape(M).numpy())
    else:
        exact = _exact("fp8", x, q, s, None)
    ulp = ulp16(np.abs(exact).max())
    got = got.double().numpy()
    np.testing.assert_allclose(got, exact, rtol=0, atol=ulp)
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * ulp)


# -------------------------------------------------- the kernel's arithmetic
@pytest.mark.parametrize("splits", [None, 3])
@pytest.mark.parametrize("layout,zero_in", [
    (layout, zi) for layout in W4_LAYOUTS for zi in (False, True)]
    + [("w8", True), ("fp8", True)])  # no zeros: one form
def test_fold_model_fp16_vs_plain(layout, zero_in, splits):
    M, K, N, group = 40, 2048, 128, 64
    x, q, s, z = _inputs(layout, M, K, N, group, seed=11)
    args = _weights(layout, q, s, z)
    xt = T(x)
    p = w.plan(layout, M, K, N, K if layout in w.COL_SCALED else group,
               splits=splits)
    if not zero_in and layout not in w.COL_SCALED:
        z = z + 0.37  # fractional zeros: the sums-of-x form
        args = (*args[:2], T(z))
    else:
        assert layout in w.COL_SCALED or w.zeros_integral(layout, args[2], F16)
    rs = (torch.rand(M, generator=torch.Generator().manual_seed(1)) + 0.5
          if layout == "fp8" else None)
    got = w.fold_model(layout, xt, args[0], args[1],
                       args[2] if len(args) > 2 else None, p, zero_in, rs)
    plain = WRAPPERS[layout](xt.float(), *args,
                             **({"row_scales": rs} if rs is not None else {}))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=1e-5 * plain.abs().max().item())


# ------------------------------------------------ the kernel's conversions
def e4m3_value(b: int) -> float:
    """An e4m3fn byte's value by the format's definition (sign, 4 exponent
    bits of bias 7, 3 mantissa bits; exponent 0 subnormal; 0x7F, 0xFF
    NaN)."""
    e, m = (b >> 3) & 15, b & 7
    mag = m / 8 * 2.0 ** -6 if e == 0 else (1 + m / 8) * 2.0 ** (e - 7)
    return float("nan") if b & 0x7F == 0x7F else -mag if b & 0x80 else mag


@pytest.mark.parametrize("dtype", [F16, B16])
def test_byte_conversions_exact(dtype):
    b = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    got = w.int8_model(b, dtype)
    assert got.dtype == dtype and torch.equal(got.float(), b.float())
    u = torch.arange(256)
    finite = torch.tensor([b & 0x7F != 0x7F for b in range(256)])
    want = torch.tensor([e4m3_value(b) for b in range(256)])
    got = w.fp8_model(u, dtype)
    assert got.dtype == dtype and finite.sum() == 254
    assert torch.equal(got.float()[finite], want[finite])
    # The kernel's fp16 instance converts by cvt.rn.f16x2.e4m3x2, the
    # exact cast: the model is that cast.
    if dtype == F16:
        cast = u.to(torch.uint8).view(torch.float8_e4m3fn).to(F16)
        assert torch.equal(got[finite], cast[finite])


def test_fp16_int8_magic_number():
    # 0x6400 | (b ^ 0x80) is 1024 + 128 + b, exact below 2048.
    b = torch.arange(-128, 128)
    bits = 0x6400 | ((b & 0xFF) ^ 0x80)
    assert torch.equal(bits.to(torch.int16).view(F16).double(),
                       1152.0 + b.double())


@pytest.mark.parametrize("dtype", [F16, B16])
@pytest.mark.parametrize("layout", W4_LAYOUTS)
def test_nibble_conversion_exact_for_every_admitted_zero(layout, dtype):
    n = torch.arange(16)
    q = (n ^ 8) - 8 if layout == "int4" else n
    admitted = [z for z in range(-4096, 4096)
                if w.zeros_integral(layout, torch.tensor([[float(z)]]),
                                    dtype)]
    lo, hi = min(admitted), max(admitted)
    assert admitted == list(range(lo, hi + 1))
    z = torch.tensor(admitted, dtype=torch.float32)[:, None]
    got = w.nibble_model(layout, n[None, :], z, dtype)
    assert got.dtype == dtype
    assert torch.equal(got.float(), q[None, :].float() - z)
    # Tight: one past either end some nibble is no longer exact.
    for zo in (lo - 1, hi + 1):
        out = w.nibble_model(layout, n, torch.tensor(float(zo)), dtype)
        assert not torch.equal(out.float(), (q - zo).float()), zo
    # The quantizers' zeros (uint4 0-15, int4 -8-7) and the magic number's
    # whole range in fp16: (2048 - 15) - (1024 + 8) + 1 zeros for int4.
    assert lo <= Q_LO[layout] and hi >= Q_LO[layout] + 15
    if dtype == F16:
        assert (lo, hi) == ((-2041, 1016) if layout == "int4"
                            else (-2033, 1024))
    else:
        assert (lo, hi) == ((-249, 120) if layout == "int4" else (-241, 128))
    # A fractional zero never takes the product's form.
    assert not w.zeros_integral(layout, torch.tensor([[3.5]]), dtype)


Q_LO = {"int4": -8, "packed": 0, "uint4": 0}


@pytest.mark.parametrize("layout", ["int4", "packed", "uint4", "w8", "fp8"])
def test_launch_is_the_same_for_bf16_and_fp16(layout, monkeypatch):
    # x's boxes hold 64 two-byte elements a row in both dtypes, so plan,
    # schedule and the shared memory (stage_bytes, ring_stages) take no
    # dtype; the prepared launches differ only in the dtype code and the
    # entry (library, symbol).
    for dt in (F16, B16):
        assert 64 * torch.finfo(dt).bits // 8 == 128
    asked = []
    monkeypatch.setattr(cuda_build, "sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda_build, "smem_optin",
                        lambda: cuda_build.H100_SMEM_OPTIN)
    monkeypatch.setattr(cuda_build, "entry", lambda name, sym, args: (
        asked.append((name, sym)) or (lambda *a: 0)))
    M, K, N, group = 40, 4096, 1424, 128
    x, q, s, z = _inputs(layout, M, K, N, group, seed=5)
    args = _weights(layout, q, s, z)
    if len(args) == 2:
        args = (*args, None)
    prepared = {}
    for dt in (B16, F16):
        asked.clear()
        fn, maps, a, p, n, cs, what, _ = w._prepare(
            layout, T(x).to(dt), *args, None, None, None, None)
        prepared[dt] = (list(a), p, asked[-1], what)
    (ab, pb, eb, _), (af, pf, ef, wf) = prepared[B16], prepared[F16]
    assert pf == pb == w.plan(layout, M, K, N,
                              K if layout in w.COL_SCALED else group)
    assert af[:13] == ab[:13] and (ab[13], af[13]) == (1, 2)
    assert eb == ("w4_wgmma", "w4_wgmma_launch")
    assert ef == ("w4_wgmma_f16", "w4_wgmma_f16_launch")
    assert "float16" in wf
    assert w.schedule(layout, pf, M, K, N) == w.schedule(layout, pb, M, K, N)
    assert w.smem_bytes(layout, pf.mt, pf.gs, pf.fold, pf.stages) \
        <= cuda_build.H100_SMEM_OPTIN


# ---------------------------------------------------------- the routing
def _meta_args(layout, M=32, K=256, N=128, group=64):
    meta = dict(device="meta")
    x = torch.empty((M, K), dtype=F16, **meta)
    if layout in w.COL_SCALED:
        return x, (torch.empty((K, N), dtype=w.Q_DTYPES[layout], **meta),
                   torch.empty(N, dtype=torch.float32, **meta))
    q = torch.empty((w.byte_rows(layout, K), N), dtype=w.Q_DTYPES[layout],
                    **meta)
    s = torch.empty((K // group, N), dtype=torch.float32, **meta)
    return x, (q, s, torch.empty_like(s))


@pytest.mark.parametrize("layout,row_scales", [
    (layout, False) for layout in ("int4", "packed", "uint4", "w8", "fp8")]
    + [("fp8", True)])
def test_wrappers_send_fp16_to_the_fp16_instance(layout, row_scales,
                                                 monkeypatch):
    calls = []

    def fake_matmul(lay, x, *args, **kw):
        calls.append((lay, x.dtype, kw.get("row_scales") is not None))
        return torch.empty((x.shape[0], args[0].shape[1]), dtype=x.dtype,
                           device=x.device)

    monkeypatch.setattr(w, "matmul", fake_matmul)
    x, args = _meta_args(layout)
    kw = {}
    if row_scales:
        kw["row_scales"] = torch.empty(x.shape[0], dtype=torch.float32,
                                       device="meta")
    fn = WRAPPERS[layout]
    before = (fn.launches, dict(fn.dtype_launches))
    y = fn(x, *args, **kw)
    assert y.dtype == F16 and tuple(y.shape) == (32, 128)
    assert calls == [(layout, F16, "row_scales" in kw)]
    assert fn.launches == before[0] + 1
    assert fn.dtype_launches == dict(before[1], float16=before[1]["float16"]
                                     + 1)
    # What the kernel takes in fp16 is what it takes in bf16.
    group = 256 if layout in w.COL_SCALED else 64
    assert w.check(layout, x, *args if len(args) == 3 else (*args, None),
                   kw.get("row_scales")) == group


def test_bf16_and_fp16_calls_prepare_two_launches(monkeypatch):
    # The prepared launch holds the entry and the instance of x's dtype:
    # a bf16 and an fp16 call on one weight at one M must not share it.
    prepared = []

    def fake_prepare(layout, x, q, scales, zeros, splits, lib, zero_in,
                     stages):
        prepared.append(x.dtype)
        return ((lambda *a: 0), None, None, w.plan(layout, *x.shape,
                                                   q.shape[1], 64),
                q.shape[1], None, "stub", None)

    monkeypatch.setattr(w, "_prepare", fake_prepare)
    monkeypatch.setattr(cuda_build, "stream", lambda dev: 0)
    monkeypatch.setattr(w, "_CALLS", {})
    x, q, s, z = _inputs("uint4", 4, 256, 64, 64, seed=6)
    q, s, z = T(q), T(s), T(z)
    for dt in (B16, F16, B16, F16):
        y = w.matmul("uint4", T(x).to(dt), q, s, z)
        assert y.dtype == dt
    assert prepared == [B16, F16]
    assert w.call_key("uint4", T(x).to(B16), q, s, z) \
        != w.call_key("uint4", T(x), q, s, z)


# ------------------------------------------------------- LLM.generate
MAX_TOKENS = 10
# name: (quantization, hidden, intermediate, layers, heads, arch); the
# packed geometries' K (2048) packs every projection at group 128.
LLM_CASES = {
    "gptq-unpacked": ("gptq", 128, 256, 2, 8, "Qwen2ForCausalLM"),
    "gptq-packed": ("gptq", 2048, 2048, 1, 16, "LlamaForCausalLM"),
    "awq": ("awq", 128, 256, 2, 8, "LlamaForCausalLM"),
    "w8a16": ("w8a16", 128, 256, 2, 8, "LlamaForCausalLM"),
    "fp8": ("fp8", 128, 256, 2, 8, "Qwen2ForCausalLM"),
    "fp8_w8a8": ("fp8_w8a8", 128, 256, 2, 8, "Qwen2ForCausalLM"),
    "int8": ("int8", 128, 256, 2, 8, "Qwen2ForCausalLM"),
}
# The ties each case may part at (test_torch_fp8_llm.py's rule; only
# fp8_w8a8 and int8 round activations to 8 bits): the counts observed,
# none.
TIES = {name: 0 for name in LLM_CASES}


def _llm_kwargs(quant, H, inter, layers, heads, arch):
    from transformers import LlamaConfig, Qwen2Config
    cls = Qwen2Config if arch == "Qwen2ForCausalLM" else LlamaConfig
    hf = cls(vocab_size=512, hidden_size=H, num_hidden_layers=layers,
             num_attention_heads=heads, num_key_value_heads=2,
             intermediate_size=inter, max_position_embeddings=512,
             rms_norm_eps=1e-5, tie_word_embeddings=False,
             architectures=[arch])
    return dict(hf_config=hf, tokenizer="unused", dtype="float16",
                load_format="dummy", device="cpu", quantization=quant,
                block_size=16, num_kv_blocks=64, max_num_seqs=4,
                max_num_batched_tokens=32, max_model_len=256)


@pytest.mark.parametrize("case", sorted(LLM_CASES))
def test_fp16_quantized_greedy_tokens_match_jax(case):
    quant, *geo = LLM_CASES[case]
    kw = _llm_kwargs(quant, *geo)
    jax_llm = JaxLLM("dummy", **kw)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 500, size=n).tolist() for n in (5, 40, 17)]
    outs = jax_llm.generate(prompts, JaxParams(
        temperature=0.0, max_tokens=MAX_TOKENS, ignore_eos=True,
        logprobs=2))
    want = [o.outputs[0].token_ids for o in outs]
    margins = [[_margin(st) for st in o.outputs[0].logprobs] for o in outs]
    port = LLM("dummy", **kw)
    port.engine.core.worker.load_params(
        params_from_jax(jax_llm.engine.core.worker.params))
    leaves = port.engine.core.worker.model.layers[0].w_qkv.leaves()
    assert ("qweight_packed" in leaves) == (case == "gptq-packed")
    before = {n: dict(fn.dtype_launches) for n, fn in qm.KERNELS.items()}
    got = [o.outputs[0].token_ids for o in port.generate(
        prompts, SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS,
                                ignore_eos=True))]
    # CPU tensors run the plain versions: no launch is counted.
    assert {n: fn.dtype_launches for n, fn in qm.KERNELS.items()} == before
    assert len({t for x in want for t in x}) > 5  # the tokens vary
    assert_tokens_match(port, prompts, want, margins, got, TIES[case])
