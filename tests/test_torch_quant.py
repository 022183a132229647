"""The port's weight-only quantization vs the JAX package's, on the same
numpy inputs:

- the plain GEMMs that the CUDA kernels' wrappers run on CPU tensors vs the
  JAX Pallas kernels in interpret mode (tolerances as in
  ``tests/ops/test_quant_matmul_pallas.py``: 2e-3, 5e-3, 2e-2), and vs the
  JAX XLA paths of ``w8a16_matmul`` / ``w4a16_matmul`` in fp32 (rtol 1e-5
  of the output scale: the port dequantizes ``(q - z) * s`` directly, the
  JAX XLA path splits out ``xsum @ (z * s)``);
- the on-the-fly quantizer and the true-4-bit packing vs
  ``quantize_stacked_params`` and ``_pack_w4_leaves`` (q, zeros and packed
  bytes equal; scales within 1e-7 relative);
- the ``llama3`` rope frequencies vs the JAX ``compute_inv_freq``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.layers import rotary as jrotary
from aphrodite_tpu.loader.weights import _pack_w4_leaves
from aphrodite_tpu.ops import quant_gemm as jgemm
from aphrodite_tpu.ops.quant_matmul_pallas import (
    w4a16_matmul_pallas, w4a16_packed_matmul_pallas, w8a16_matmul_pallas)
from aphrodite_tpu.quantization.base import QuantizationConfig as JaxQCfg
from aphrodite_tpu.quantization.loader import quantize_stacked_params
from aphrodite_tpu_torch.layers import rotary as trotary
from aphrodite_tpu_torch.layers.linear import apply_linear
from aphrodite_tpu_torch.loader.weights import params_from_jax
from aphrodite_tpu_torch.ops import quant_gemm, quant_matmul as qm
from aphrodite_tpu_torch.quantization.base import QuantizationConfig
from aphrodite_tpu_torch.quantization.loader import (pack_w4,
                                                     quantize_weight,
                                                     w4_packs)

T = torch.from_numpy


def _w4_case(M, K, N, group, seed=0):
    rng = np.random.RandomState(seed)
    G = K // group
    x = rng.randn(M, K).astype(np.float32)
    q = rng.randint(0, 16, (K, N)).astype(np.int8)
    s = (rng.rand(G, N) * 0.05 + 0.01).astype(np.float32)
    z = rng.randint(0, 16, (G, N)).astype(np.float32)
    return x, q, s, z


def _packed(q):
    K = q.shape[0]
    return (q[:K // 2].astype(np.uint8) | (q[K // 2:].astype(np.uint8) << 4))


def _dense(q, s, z):
    K, N = q.shape
    G = s.shape[0]
    return ((q.reshape(G, K // G, N).astype(np.float64) - z[:, None])
            * s[:, None]).reshape(K, N)


# ---------------------------------------------------- vs the Pallas kernels
@pytest.mark.parametrize("M,K,N", [(8, 64, 128), (32, 256, 192), (5, 128, 64)])
def test_w8a16_vs_pallas_interpret(M, K, N):
    rng = np.random.RandomState(1)
    x = rng.randn(M, K).astype(np.float32)
    q = rng.randint(-127, 127, (K, N)).astype(np.int8)
    s = (rng.rand(N) * 0.1).astype(np.float32)
    ref = np.asarray(w8a16_matmul_pallas(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), block_n=64,
        block_k=32, interpret=True))
    got = qm.w8a16_matmul(T(x), T(q), T(s)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("M,K,N,group", [(8, 128, 64, 32), (16, 256, 128, 64),
                                         (4, 64, 96, 64)])
def test_w4a16_vs_pallas_interpret(M, K, N, group):
    x, q, s, z = _w4_case(M, K, N, group)
    ref = np.asarray(w4a16_matmul_pallas(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(z),
        block_n=64, block_k=64, interpret=True))
    got = qm.w4a16_matmul(T(x), T(q), T(s), T(z)).numpy()
    np.testing.assert_allclose(got, ref, rtol=5e-3, atol=5e-3)


def test_w4a16_packed_vs_pallas_interpret():
    x, q, s, z = _w4_case(8, 2048, 256, 128)
    qp = _packed(q)
    ref = np.asarray(w4a16_packed_matmul_pallas(
        jnp.asarray(x), jnp.asarray(qp.view(np.int8)), jnp.asarray(s),
        jnp.asarray(z), block_k=2048, block_n=128, interpret=True))
    got = qm.w4a16_packed_matmul(T(x), T(qp), T(s), T(z)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


# ------------------------------------------------------ vs the JAX XLA path
def _close_to_scale(got, ref):
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("M", [32, 300])
def test_w8a16_route_vs_jax_xla(M):
    rng = np.random.RandomState(2)
    K, N = 256, 384
    x = rng.randn(M, K).astype(np.float32)
    q = rng.randint(-128, 128, (K, N)).astype(np.int8)
    s = (rng.rand(N) * 0.02).astype(np.float32)
    ref = np.asarray(jgemm.w8a16_matmul(jnp.asarray(x), jnp.asarray(q),
                                        jnp.asarray(s)))
    got = quant_gemm.w8a16_matmul(T(x), T(q), T(s)).numpy()
    _close_to_scale(got, ref)
    np.testing.assert_allclose(got, x.astype(np.float64) @ q * s,
                               rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("M", [7, 256, 300])
@pytest.mark.parametrize("perm", [False, True])
def test_w4a16_route_vs_jax_xla(packed, M, perm):
    K, N, group = 2048, 128, 128
    x, q, s, z = _w4_case(M, K, N, group, seed=3)
    kw_j, kw_t = {}, {}
    if perm:
        p = np.random.RandomState(4).permutation(K).astype(np.int32)
        kw_j["input_perm"], kw_t["input_perm"] = jnp.asarray(p), T(p)
    if packed:
        qp = _packed(q)
        ref = jgemm.w4a16_matmul(jnp.asarray(x), None, jnp.asarray(s),
                                 jnp.asarray(z),
                                 qpacked=jnp.asarray(qp.view(np.int8)),
                                 **kw_j)
        got = quant_gemm.w4a16_matmul(T(x), None, T(s), T(z),
                                      qpacked=T(qp), **kw_t)
    else:
        ref = jgemm.w4a16_matmul(jnp.asarray(x), jnp.asarray(q),
                                 jnp.asarray(s), jnp.asarray(z), **kw_j)
        got = quant_gemm.w4a16_matmul(T(x), T(q), T(s), T(z), **kw_t)
    ref = np.asarray(ref)
    _close_to_scale(got.numpy(), ref)
    xp = x[:, p] if perm else x
    _close_to_scale(got.numpy(), xp.astype(np.float64) @ _dense(q, s, z))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed,K,group", [(False, 1152, 128),
                                            (False, 96, 32), (True, 512, 32),
                                            (True, 2048, 128)])
def test_w4a16_prefill_dequant_slabs(packed, K, group, dtype):
    """M > 256 dequantizes W a slab of groups at a time straight into x's
    dtype; the product equals the one through a whole-W fp32 dequantize,
    bit for bit (slabs that end short of K included)."""
    x, q, s, z = _w4_case(300, K, 64, group, seed=6)
    xt = T(x).to(dtype)
    w = qm.dequant_w4(T(q), T(s), T(z)).to(dtype)
    ref = (xt.float() @ w.float()).to(dtype)
    if packed:
        got = quant_gemm.w4a16_matmul(xt, None, T(s), T(z),
                                      qpacked=T(_packed(q)))
    else:
        got = quant_gemm.w4a16_matmul(xt, T(q), T(s), T(z))
    assert got.dtype == dtype
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_apply_linear_formats():
    x, q, s, z = _w4_case(3, 128, 64, 128, seed=5)
    b = np.arange(64, dtype=np.float32)
    got = apply_linear(T(x), {"qweight": T(q), "scales": T(s),
                              "zeros": T(z)}, T(b), fmt="w4a16")
    np.testing.assert_allclose(got.numpy(), x @ _dense(q, s, z) + b,
                               rtol=0, atol=1e-4)
    with pytest.raises(NotImplementedError):
        apply_linear(T(x), {"qweight": T(q), "scales": T(s[0])}, fmt="fp8")


# ------------------------------------------------ quantizer and packing
@pytest.mark.parametrize("method,K", [("gptq", 2048), ("awq", 256),
                                      ("gptq", 64), ("w8a16", 192)])
def test_quantizer_and_packing_match_jax(method, K):
    N, L = 96, 2
    rng = np.random.RandomState(6)
    w = (rng.randn(L, K, N) * 0.02).astype(np.float32)
    w[0, :, 0] = 0.0          # a constant column: the 1e-8 scale floor
    w[1, :, 1] = np.abs(w[1, :, 1])   # all-positive: zero point clips to 0
    jtree = quantize_stacked_params({"layers": {"wq": w.copy()}},
                                    JaxQCfg.from_name(method))
    jtree = _pack_w4_leaves(jtree)["layers"]["wq"]
    qcfg = QuantizationConfig.from_name(method)
    for i in range(L):
        got = {k: v.numpy() for k, v in
               quantize_weight(T(w[i]), qcfg).items()}
        exp = {k: np.asarray(v)[i] for k, v in jtree.items()}
        if "qweight_packed" in exp:
            exp["qweight_packed"] = exp["qweight_packed"].view(np.uint8)
        assert sorted(got) == sorted(exp)
        for k in got:
            if k == "scales":
                np.testing.assert_allclose(got[k], exp[k], rtol=1e-7, atol=0)
            else:
                assert got[k].dtype == exp[k].dtype, k
                np.testing.assert_array_equal(got[k], exp[k])
    assert w4_packs(2048, 128) and not w4_packs(1536, 128) \
        and not w4_packs(8960, 128) and w4_packs(14336, 128)


def test_pack_unpack_round_trip():
    q = np.random.RandomState(7).randint(0, 16, (2048, 8)).astype(np.int8)
    packed = pack_w4(T(q))
    assert packed.dtype == torch.uint8 and packed.shape == (1024, 8)
    np.testing.assert_array_equal(packed.numpy(), _packed(q))
    np.testing.assert_array_equal(qm.unpack_w4(packed).numpy(), q)


def test_unported_quantization_raises():
    with pytest.raises(NotImplementedError):
        QuantizationConfig.from_name("fp8")
    from aphrodite_tpu_torch.config import ModelConfig
    from aphrodite_tpu_torch.quantization.base import get_quantization_config
    geo = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
               num_attention_heads=2, architectures=["LlamaForCausalLM"])
    assert get_quantization_config(ModelConfig("m", hf_config=geo)) is None
    with pytest.raises(NotImplementedError):
        get_quantization_config(ModelConfig(
            "m", hf_config=geo, quantization="gptq", quantize_lm_head=True))
    with pytest.raises(NotImplementedError):
        get_quantization_config(ModelConfig("m", hf_config={
            **geo, "quantization_config": {"quant_method": "gptq"}}))


def test_params_from_jax_fuses_quantized_leaves():
    rng = np.random.RandomState(8)
    L, K, G = 2, 64, 1
    perm = np.stack([rng.permutation(K) for _ in range(L)]).astype(np.int32)

    def leaf(n, p=perm):
        return {"qweight": rng.randint(0, 16, (L, K, n)).astype(np.int8),
                "scales": rng.rand(L, G, n).astype(np.float32),
                "zeros": rng.rand(L, G, n).astype(np.float32),
                "input_perm": p}

    layers = {"input_norm": np.ones((L, K), np.float32),
              "post_norm": np.ones((L, K), np.float32),
              "wq": leaf(64), "wk": leaf(32), "wv": leaf(32), "wo": leaf(K),
              "w_gate": leaf(96), "w_up": leaf(96), "w_down": leaf(K)}
    tree = {"embed": np.zeros((8, K), np.float32),
            "final_norm": np.ones((K,), np.float32), "layers": layers}
    state = params_from_jax(tree)
    np.testing.assert_array_equal(
        state["layers.1.w_qkv.scales"], np.concatenate(
            [layers[k]["scales"][1] for k in ("wq", "wk", "wv")], axis=-1))
    np.testing.assert_array_equal(state["layers.0.w_gate_up.input_perm"],
                                  perm[0])
    assert state["layers.0.wo.qweight"].shape == (K, K)
    layers["wk"] = leaf(32, perm[::-1].copy())
    with pytest.raises(NotImplementedError):
        params_from_jax(tree)


# ------------------------------------------------------------ llama3 rope
@pytest.mark.parametrize("head_dim,base,orig", [(128, 500000.0, 8192),
                                                (64, 10000.0, 256)])
def test_llama3_inv_freq_matches_jax(head_dim, base, orig):
    scaling = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": orig}
    inv_j, ms = jrotary.compute_inv_freq(jrotary.RopeConfig(
        head_dim=head_dim, rotary_dim=head_dim, base=base, scaling=scaling))
    inv_t = trotary.compute_inv_freq(trotary.RopeConfig(
        head_dim=head_dim, rotary_dim=head_dim, base=base, scaling=scaling))
    assert ms == 1.0
    np.testing.assert_array_equal(inv_t, inv_j)


@pytest.mark.parametrize("method", ["gptq", "w8a16"])
def test_dummy_quantized_model_leaves(method):
    """The port's own dummy + quantize path (no JAX tree): leaves of the
    right layout whose dequantized weights stay within half a step of an
    N(0, 0.02) draw's range."""
    from aphrodite_tpu_torch.config import ModelConfig
    from aphrodite_tpu_torch.loader.weights import create_model
    geo = dict(vocab_size=64, hidden_size=2048, num_hidden_layers=1,
               num_attention_heads=16, num_key_value_heads=2,
               intermediate_size=64, architectures=["LlamaForCausalLM"])
    qcfg = QuantizationConfig.from_name(method)
    m = create_model(ModelConfig("m", hf_config=geo, dtype="bfloat16"),
                     "cpu", qcfg)
    m.init_dummy_params(torch.Generator().manual_seed(0))
    layer = m.layers[0]
    assert m.quant_fmt == ("w4a16" if method == "gptq" else "w8a16")
    for name, K in (("w_qkv", 2048), ("wo", 2048), ("w_gate_up", 2048),
                    ("w_down", 64)):
        lv = getattr(layer, name).leaves()
        if method == "w8a16":
            w = lv["qweight"].float() * lv["scales"]
        else:
            assert ("qweight_packed" in lv) == (K == 2048), name
            q = (qm.unpack_w4(lv["qweight_packed"]) if K == 2048
                 else lv["qweight"])
            assert 0 <= int(q.min()) and int(q.max()) <= 15
            w = qm.dequant_w4(q, lv["scales"], lv["zeros"])
        assert w.shape[0] == K and torch.isfinite(w).all()
        assert 0.02 < float(w.std()) * 1.1 and float(w.abs().max()) < 0.2
