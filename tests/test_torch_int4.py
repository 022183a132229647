"""The port's native-int4 W4A16 path vs the JAX package's, on the same
numpy inputs:

- ``realize_int4_leaves`` on a loaded model vs the JAX function of that
  name on the same packed tree: values and shifted zeros equal bit for bit
  (as ``tests/quantization/test_int4_path.py`` checks the JAX one), and
  ``params_from_jax`` of the JAX realization equals the port's realization;
- the int4 kernel's plain version vs ``w4a16_int4_matmul_pallas`` in
  interpret mode and vs ``w4a16_int4_grouped`` (``_case`` and the
  tolerance of ``test_int4_path.py``: rtol 2e-4, atol 2e-3);
- ``w4a16_matmul(qweight4=...)`` at M 16, 128 and 512 (the grouped, kernel
  and dequantize bands) vs the JAX ``w4a16_matmul(qweight4=...)`` with its
  Pallas kernel in interpret mode (atol 5e-3, as there)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.loader.weights import \
    realize_int4_leaves as jax_realize_int4_leaves
from aphrodite_tpu.ops import quant_gemm as jgemm
from aphrodite_tpu.ops.quant_matmul_pallas import w4a16_int4_matmul_pallas
from aphrodite_tpu_torch import LLM
from aphrodite_tpu_torch.loader.weights import (params_from_jax,
                                                realize_int4_leaves)
from aphrodite_tpu_torch.ops import quant_gemm, quant_matmul as qm

T = torch.from_numpy


def _case(M, K, N, group, seed=0):
    # tests/quantization/test_int4_path.py:_case: values and zeros in
    # [-8, 8), the int4 layout's range.
    rng = np.random.default_rng(seed)
    q = rng.integers(-8, 8, size=(K, N)).astype(np.int8)
    G = K // group
    s = rng.uniform(0.5, 1.5, size=(G, N)).astype(np.float32)
    z = rng.integers(-8, 8, size=(G, N)).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w_deq = ((q.reshape(G, group, N).astype(np.float32) - z[:, None, :])
             * s[:, None, :]).reshape(K, N)
    return x, q, s, z, x @ w_deq


def test_pack_int4_round_trip_and_layout():
    q = np.random.default_rng(1).integers(-8, 8, size=(64, 12)).astype(
        np.int8)
    p = qm.pack_int4(T(q))
    assert p.dtype == torch.uint8 and tuple(p.shape) == (32, 12)
    # byte [r, n]: row 2r in the low nibble, row 2r + 1 in the high one
    np.testing.assert_array_equal(p.numpy() & 0xF, q[0::2] & 0xF)
    np.testing.assert_array_equal(p.numpy() >> 4, q[1::2] & 0xF)
    np.testing.assert_array_equal(qm.unpack_int4(p).numpy(), q)


@pytest.mark.parametrize("M,K,N,group,seed", [(128, 512, 256, 128, 1),
                                              (72, 256, 96, 32, 4),
                                              (5, 256, 64, 256, 5)])
def test_int4_plain_vs_pallas_interpret_and_grouped(M, K, N, group, seed):
    x, q, s, z, exp = _case(M, K, N, group, seed)
    q4p = qm.pack_int4(T(q))
    got = qm.w4a16_int4_matmul(T(x), q4p, T(s), T(z)).numpy()
    kern = np.asarray(w4a16_int4_matmul_pallas(
        jnp.asarray(x), jnp.asarray(q).astype(jnp.int4), jnp.asarray(s),
        jnp.asarray(z), block_n=min(128, N), block_k=min(256, K),
        interpret=True))
    grouped = quant_gemm.w4a16_int4_grouped(T(x), q4p, T(s), T(z)).numpy()
    for other in (kern, grouped, exp):
        np.testing.assert_allclose(got, other, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("M", [16, 128, 512])
def test_w4a16_matmul_int4_bands_vs_jax(M, monkeypatch):
    # The JAX dispatch takes its Pallas kernel at 64 < M <= 256 only in
    # interpret mode on the CPU (test_int4_path.py sets the same variable).
    monkeypatch.setenv("APHRODITE_PALLAS_INTERPRET", "1")
    x, q, s, z, exp = _case(M, 512, 256, 128, seed=2)
    ref = np.asarray(jgemm.w4a16_matmul(
        jnp.asarray(x), None, jnp.asarray(s), jnp.asarray(z),
        qweight4=jnp.asarray(q).astype(jnp.int4)))
    got = quant_gemm.w4a16_matmul(T(x), None, T(s), T(z),
                                  qweight4=qm.pack_int4(T(q))).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=5e-3)
    np.testing.assert_allclose(got, exp, rtol=2e-4, atol=5e-3)


def _tiny_gptq(jax: bool):
    """A one-layer Llama whose four projections all pack under gptq's group
    of 128 (K = 2048: (K/2) % (8 * 128) == 0), with the dummy weights
    quantized on the fly."""
    from transformers import LlamaConfig
    hf = LlamaConfig(vocab_size=128, hidden_size=2048, num_hidden_layers=1,
                     num_attention_heads=16, num_key_value_heads=2,
                     intermediate_size=2048, max_position_embeddings=256,
                     tie_word_embeddings=False,
                     architectures=["LlamaForCausalLM"])
    kw = dict(hf_config=hf, tokenizer="unused", dtype="float32",
              load_format="dummy", device="cpu", quantization="gptq",
              block_size=16, num_kv_blocks=16, max_num_seqs=2,
              max_num_batched_tokens=32, max_model_len=128)
    if jax:
        from aphrodite_tpu.entrypoints.llm import LLM as JaxLLM
        return JaxLLM("dummy", **kw)
    return LLM("dummy", **kw)


def test_realize_int4_leaves_vs_jax_bit_for_bit():
    jax_tree = _tiny_gptq(jax=True).engine.core.worker.params
    packed = params_from_jax(jax_tree)
    assert any(k.endswith(".qweight_packed") for k in packed)
    port = _tiny_gptq(jax=False)
    model = port.engine.core.worker.model
    port.engine.core.worker.load_params(packed)
    realize_int4_leaves(model)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    assert not any(k.endswith(".qweight_packed") for k in state)
    # The JAX realization of the same packed tree, carried over.
    want = params_from_jax(jax_realize_int4_leaves(jax_tree))
    assert sorted(state) == sorted(want)
    n4 = 0
    for k, v in want.items():
        assert v.dtype == state[k].dtype, k
        np.testing.assert_array_equal(state[k], v, err_msg=k)
        if k.endswith(".qweight4"):
            n4 += 1
            # q - 8 and the -8 shift of the zeros, as the JAX test checks
            base = k[:-len(".qweight4")]
            np.testing.assert_array_equal(
                qm.unpack_int4(T(v)).numpy(),
                qm.unpack_w4(T(packed[base + ".qweight_packed"])).numpy()
                - 8)
            np.testing.assert_array_equal(
                state[base + ".zeros"], packed[base + ".zeros"] - 8.0)
    assert n4 == 4  # w_qkv, wo, w_gate_up, w_down


def test_realized_model_computes_the_packed_function():
    port = _tiny_gptq(jax=False)
    model = port.engine.core.worker.model
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(80, 2048)).astype(np.float32))
    before = model._lin(x, model.layers[0].w_qkv)
    realize_int4_leaves(model)
    assert "qweight4" in model.layers[0].w_qkv.leaves()
    for M in (8, 80):  # the grouped and the kernel band
        np.testing.assert_allclose(model._lin(x[:M], model.layers[0].w_qkv),
                                   before[:M], rtol=1e-4, atol=1e-5)
