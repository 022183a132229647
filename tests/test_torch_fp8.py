"""FP8 and int8 W8A8 and the fp8 KV cache of the PyTorch port vs the JAX
package, on the same numpy inputs (the CUDA kernels run only on the card,
where ``chip_smoke.py`` phase 2 holds them against these plain versions):

- ``quant_gemm.fp8_matmul`` (per-column and blockwise weight scales,
  weight-only, dynamic per-token and static activation scales, M on both
  sides of 256) and ``int8_matmul`` against ``aphrodite_tpu.ops.quant_gemm``
  under ``jax.jit`` (the model's forward is jitted, and XLA then takes
  ``/ 448`` and ``/ 127`` as products with the reciprocal): fp32, rtol
  1e-5 of the output scale (the same e4m3 or int8 operands, the products
  summed in another order); int8's int32 product is exact;
- the on-the-fly quantizer (fp8, int8) against ``quantize_stacked_params``:
  equal bytes, equal scales;
- the cast of K/V into an fp8 cache (``attention.backend.cast_to``)
  against ``astype`` in JAX: equal bytes for every bf16 value and for
  fp32 edges (e4m3: 460 -> 448, 464 -> 448, 464.01 and 500 -> NaN);
- the four attention wrappers' plain versions on e4m3 and e5m2 caches
  against the JAX oracles (atol 1e-5) and the Pallas kernels in interpret
  mode (atol 1e-5; the window 5e-3, see ``test_window_fp8``);
- the window tails' dtype (bf16 beside e5m2, else the cache's) against the
  JAX window on the same cache;
- the "fp8" layout of ``ops/w4_wgmma.py`` (plan, schedule, shared memory,
  ``fold_model``, ``fp8_model``), as ``tests/test_torch_byte_wgmma.py``
  does for "w8";
- ``params_from_jax`` and ``load_params`` with fp8 leaves, bit for bit.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from aphrodite_tpu.attention.backend import (
    ref_ragged_paged_attention as jax_ref_ragged)
from aphrodite_tpu.attention.backend import write_kv as jax_write_kv
from aphrodite_tpu.attention.backend import write_tail as jax_write_tail
from aphrodite_tpu.attention.metadata import AttentionMetadata as JaxMD
from aphrodite_tpu.ops import cascade_attention as jcascade
from aphrodite_tpu.ops import quant_gemm as jgemm
from aphrodite_tpu.ops.decode_paged_attention import (
    decode_paged_attention as jax_decode_kernel)
from aphrodite_tpu.ops.ragged_paged_attention import (
    ragged_paged_attention as jax_ragged_kernel)
from aphrodite_tpu.ops.window_decode_attention import (
    ref_window_decode_attention as jax_ref_window)
from aphrodite_tpu.ops.window_decode_attention import (
    window_decode_attention as jax_window_kernel)
from aphrodite_tpu.quantization.base import QuantizationConfig as JaxQCfg
from aphrodite_tpu.quantization.loader import quantize_stacked_params
from aphrodite_tpu_torch.attention.backend import (cast_to, write_kv,
                                                   write_tail)
from aphrodite_tpu_torch.attention.metadata import (AttentionMetadata,
                                                    build_work_items)
from aphrodite_tpu_torch.loader.weights import load_params, params_from_jax
from aphrodite_tpu_torch.ops import cascade_attention as cascade
from aphrodite_tpu_torch.ops import quant_gemm
from aphrodite_tpu_torch.ops import quant_matmul as qm
from aphrodite_tpu_torch.ops import w4_wgmma as w
from aphrodite_tpu_torch.ops.cuda_build import H100_SMEM_OPTIN
from aphrodite_tpu_torch.ops.decode_paged_attention import (
    decode_launch_geometry, decode_paged_attention)
from aphrodite_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention, ragged_work_item_tokens)
from aphrodite_tpu_torch.ops.window_decode_attention import (
    tail_dtype, window_decode_attention, window_launch_geometry)
from aphrodite_tpu_torch.quantization.base import (QuantizationConfig,
                                                   runtime_format)
from aphrodite_tpu_torch.quantization.loader import quantize_weight
from tests.test_torch_attention import (KVH, LAYER, NQ, PAGE, _jax_md,
                                        _ragged_case)

T = torch.from_numpy
F8 = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
      "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}
L = 2


def to_torch(a) -> torch.Tensor:
    """A JAX array (bf16 and fp8 included) as a torch tensor, bit for bit."""
    a = np.asarray(a)
    bits = {"bfloat16": (np.uint16, torch.bfloat16),
            "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
            "float8_e5m2": (np.uint8, torch.float8_e5m2)}.get(a.dtype.name)
    if bits is None:
        return T(np.ascontiguousarray(a))
    return T(np.ascontiguousarray(a).view(bits[0])).view(bits[1])


def close(got, want, scale_rtol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=scale_rtol * max(np.abs(want).max(), 1))


# ------------------------------------------------------------------ GEMMs
def _fp8_case(M, K, N, block, seed):
    """tests/quantization/test_fp8_w8a8.py's inputs: x, e4m3 weights and
    their scales (per column, or blockwise with ``block``)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    w_ = rng.randn(K, N).astype(np.float32) * 0.1
    if block:
        ws = np.abs(w_).reshape(K // block, block, N // block,
                                block).max(axis=(1, 3)) / 448.0
        w8 = (w_ / np.repeat(np.repeat(ws, block, 0), block, 1)).astype(
            ml_dtypes.float8_e4m3fn)
    else:
        ws = np.abs(w_).max(0) / 448.0
        w8 = (w_ / ws).astype(ml_dtypes.float8_e4m3fn)
    return x, w8, ws.astype(np.float32)


@pytest.mark.parametrize("M", [4, 300])
@pytest.mark.parametrize("case", ["weight-only", "dynamic", "static",
                                  "blockwise", "blockwise-weight-only"])
def test_fp8_matmul_vs_jax(case, M):
    block = 32 if case.startswith("blockwise") else 0
    K, N = (128, 64) if block else (64, 32)
    x, w8, ws = _fp8_case(M, K, N, block, seed=len(case) + M)
    act = case in ("dynamic", "static", "blockwise")
    # The static scale keeps |x / s| <= 448 (no NaN on either side).
    iscale = (np.asarray(np.abs(x).max() / 448.0, np.float32)
              if case == "static" else None)
    fn = jax.jit(lambda a, b, c, d: jgemm.fp8_matmul(
        a, b, c, input_scale=d, act_quant=act))
    want = fn(jnp.asarray(x), jnp.asarray(w8), jnp.asarray(ws),
              None if iscale is None else jnp.asarray(iscale))
    got = quant_gemm.fp8_matmul(
        T(x), to_torch(w8), T(ws),
        input_scale=None if iscale is None else T(iscale), act_quant=act)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    close(got.numpy(), want)


@pytest.mark.parametrize("M", [3, 40, 300])
def test_int8_matmul_vs_jax(M):
    rng = np.random.RandomState(M)
    K, N = 96, 48
    x = rng.randn(M, K).astype(np.float32)
    q = rng.randint(-128, 128, (K, N)).astype(np.int8)
    s = rng.uniform(1e-3, 2e-3, N).astype(np.float32)
    want = jax.jit(jgemm.int8_matmul)(jnp.asarray(x), jnp.asarray(q),
                                      jnp.asarray(s))
    got = quant_gemm.int8_matmul(T(x), T(q), T(s))
    close(got.numpy(), want, 1e-6)


def test_w8a8_rows_round_to_e4m3_as_jax_does():
    # The per-token quantize feeding the decode kernel: equal bytes and
    # scales (x / xs is a true division in both; xs is amax * (1 / 448)).
    rng = np.random.RandomState(3)
    x = (rng.randn(37, 256) * np.exp(rng.uniform(-3, 3, (37, 1)))).astype(
        np.float32)

    @jax.jit
    def jax_rows(a):
        xs = jnp.maximum(jnp.max(jnp.abs(a), axis=-1, keepdims=True)
                         / 448.0, 1e-10)
        return (a / xs).astype(jnp.float8_e4m3fn), xs
    j8, jxs = jax_rows(jnp.asarray(x))
    x8, xs = quant_gemm.fp8_quantize_rows(T(x))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(
        x8.to(torch.float8_e4m3fn).view(torch.uint8).numpy(),
        np.asarray(j8).view(np.uint8))


@pytest.mark.parametrize("method", ["fp8", "int8"])
def test_quantizer_bytes_match_jax(method):
    Lq, K, N = 2, 192, 80
    rng = np.random.RandomState(4)
    w_ = (rng.randn(Lq, K, N) * 0.02).astype(np.float32)
    w_[0, :, 0] = 0.0                 # the scale floor
    w_[1, :, 1] = np.abs(w_[1, :, 1])
    w_[1, 5, 2] = 3.0                 # one large weight a column
    wb = np.asarray(jnp.asarray(w_).astype(jnp.bfloat16))
    jtree = quantize_stacked_params({"layers": {"wq": wb.copy()}},
                                    JaxQCfg.from_name(method))
    jl = jtree["layers"]["wq"]
    scale_key = "weight_scale" if method == "fp8" else "scales"
    qcfg = QuantizationConfig.from_name(method)
    for i in range(Lq):
        got = quantize_weight(to_torch(wb[i]), qcfg)
        assert sorted(got) == sorted(jl)
        np.testing.assert_array_equal(got["qweight"].view(torch.uint8)
                                      .numpy(),
                                      np.asarray(jl["qweight"][i])
                                      .view(np.uint8))
        np.testing.assert_array_equal(got[scale_key].numpy(),
                                      np.asarray(jl[scale_key][i]))


@pytest.mark.parametrize("name,fmt", [
    ("fp8", "fp8"), ("fp8_w8a8", "fp8_w8a8"), ("fp8-dynamic", "fp8_w8a8"),
    ("ptpc_fp8", "fp8_w8a8"), ("int8", "int8"), ("tpu_int8", "int8")])
def test_quantization_names_match_jax(name, fmt):
    port, ref = QuantizationConfig.from_name(name), JaxQCfg.from_name(name)
    assert runtime_format(port) == fmt
    assert port.method == ref.method
    assert port.activation_scheme == ref.activation_scheme


# -------------------------------------------------------- the K/V write
def same_bytes(got: torch.Tensor, want: np.ndarray, dtype) -> None:
    """Equal bytes wherever the reference is a number; NaN wherever it is
    NaN. A NaN input's sign and payload bits differ between XLA's own
    paths (bf16 -> e5m2 gives 0x7f for any NaN, fp32 -> e5m2 keeps the
    sign as 0x7e / 0xfe) and are not matched; a finite input that
    overflows e4m3 gives NaN with its sign, as in XLA, bit for bit."""
    nan = np.isnan(T(want.copy()).view(dtype).float().numpy())
    g = got.view(torch.uint8).numpy()
    np.testing.assert_array_equal(g[~nan], want[~nan])
    assert torch.isnan(got.float()[T(nan)]).all()


@pytest.mark.parametrize("kind", ["e4m3", "e5m2"])
def test_cast_to_fp8_matches_astype_for_every_bf16(kind):
    jd, td = F8[kind]
    bits = np.arange(65536, dtype=np.uint16)
    want = np.asarray(jnp.asarray(bits).view(jnp.bfloat16).astype(jd)
                      ).view(np.uint8)
    got = cast_to(T(bits.view(np.int16)).view(torch.bfloat16), td)
    same_bytes(got, want, td)


@pytest.mark.parametrize("kind", ["e4m3", "e5m2"])
def test_cast_to_fp8_matches_astype_in_fp32(kind):
    jd, td = F8[kind]
    rng = np.random.RandomState(5)
    x = np.concatenate([
        rng.randn(20000) * np.exp(rng.uniform(-14, 7, 20000)),
        [460, -460, 464, 464.01, -464.01, 500, -500, 448, 479.9, 480,
         np.inf, -np.inf, 2.0 ** -9, 2.0 ** -10, 1.5 * 2 ** -10, 0.0,
         57344, 61440, 1e6]]).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: a.astype(jd))(jnp.asarray(x))
                      ).view(np.uint8)
    same_bytes(cast_to(T(x), td), want, td)
    if kind == "e4m3":  # the overflow's NaN keeps its sign, as in XLA
        np.testing.assert_array_equal(
            cast_to(T(x), td).view(torch.uint8).numpy(), want)


def test_e4m3_write_rule_500_is_nan_460_is_448():
    cache = torch.zeros(L, 3, 2, 1, PAGE, 4, dtype=torch.float8_e4m3fn)
    k = torch.tensor([[[500.0, 460.0, -500.0, 464.0]]])
    write_kv(cache, 1, k, -k, torch.tensor([PAGE + 2]))
    kk, vv = cache[1, 1, 0, 0, 2].float(), cache[1, 1, 1, 0, 2].float()
    assert torch.isnan(kk[0]) and kk[1] == 448 and kk[3] == 448
    assert torch.isnan(kk[2]) and torch.isnan(vv[0]) and vv[1] == -448
    jc = jax_write_kv(jnp.zeros((L, 3, 2, 1, PAGE, 4), jnp.float8_e4m3fn),
                      jnp.asarray(k.numpy()), jnp.asarray(-k.numpy()),
                      jnp.asarray([PAGE + 2]), layer_idx=1)
    np.testing.assert_array_equal(cache.view(torch.uint8).numpy(),
                                  np.asarray(jc).view(np.uint8))


# ---------------------------------------------------- attention on fp8
def _fp8_cache(cache: np.ndarray, kind: str):
    jc = jnp.asarray(cache).astype(F8[kind][0])
    return jc, to_torch(jc)


def _port_md(c):
    items = build_work_items(c["qsl"][:-1], np.diff(c["qsl"]),
                             c["seq_lens"], c["R"], 32)
    return AttentionMetadata(
        token_req_idx=T(c["tok_req"]), token_pos=T(c["tok_pos"]),
        slot_mapping=T(c["slots"].astype(np.int64)),
        seq_lens=T(c["seq_lens"]), block_tables=T(c["bt"]), block_q=32,
        **{k: T(v) for k, v in items.items()})


@pytest.mark.parametrize("opts", [{}, {"sliding_window": 16},
                                  {"logits_soft_cap": 30.0}])
@pytest.mark.parametrize("kind", ["e4m3", "e5m2"])
def test_ragged_fp8(kind, opts):
    c = _ragged_case([(40, 40), (13, 13), (37, 1), (25, 1)])
    jc, tc = _fp8_cache(c["cache"], kind)
    md, hd = _jax_md(c), c["q"].shape[-1]
    got = ragged_paged_attention(T(c["q"]), tc, LAYER, _port_md(c),
                                 hd ** -0.5, **opts).numpy()
    q = jnp.asarray(c["q"])
    ref = jax_ref_ragged(q, jc[LAYER], md, hd ** -0.5, **opts)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)
    kern, _ = jax_ragged_kernel(q, jc, md, hd ** -0.5, block_q=32,
                                chunk_pages=2, interpret=True,
                                layer_idx=LAYER, **opts)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=0, atol=1e-5)


def _window_case(kind, seed=1, hd=64, kw=4, plens=(40, 13, 70, 0)):
    """A window on an fp8 cache with tails in the JAX runner's tail dtype
    (runner.py:519-520), made by each package's write_tail from the same
    fp32 rows."""
    rng = np.random.RandomState(seed)
    R, mp = len(plens), 6
    cache = (rng.randn(L, R * mp + 1, 2, KVH, PAGE, hd) * 0.3).astype(
        np.float32)
    jc, tc = _fp8_cache(cache, kind)
    bt = np.arange(1, R * mp + 1).reshape(R, mp).astype(np.int32)
    jtd = (jnp.bfloat16 if F8[kind][0] in (jnp.float8_e4m3, jnp.float8_e5m2)
           else F8[kind][0])
    rows = (rng.randn(kw, 2, R, KVH, hd) * 0.3).astype(np.float32)
    jt = [jnp.zeros((L, R, KVH, kw, hd), jtd) for _ in range(2)]
    tt = [torch.zeros((L, R, KVH, kw, hd),
                      dtype=tail_dtype(F8[kind][1])) for _ in range(2)]
    for step in range(kw):
        for i in range(2):
            jt[i] = jax_write_tail(jt[i], jnp.asarray(rows[step, i]), LAYER,
                                   step)
            write_tail(tt[i], T(rows[step, i]), LAYER, step)
    q = (rng.randn(R, NQ, hd) * 0.3).astype(np.float32)
    return q, jc, tc, jt, tt, bt, np.asarray(plens, np.int32)


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("kind", ["e4m3", "e5m2"])
def test_window_fp8(kind, step):
    q, jc, tc, jt, tt, bt, pl = _window_case(kind)
    # The tails hold what the JAX runner's tails hold, bit for bit.
    for a, b in zip(jt, tt):
        assert b.dtype == {"e4m3": torch.float8_e4m3fn,
                           "e5m2": torch.bfloat16}[kind]
        assert torch.equal(to_torch(a).view(torch.uint8),
                           b.view(torch.uint8))
    got = window_decode_attention(T(q), tc, tt[0], tt[1], LAYER, step, T(pl),
                                  T(bt), 0.125).numpy()
    ref = jax_ref_window(jnp.asarray(q), jc[LAYER], jt[0][LAYER],
                         jt[1][LAYER], jnp.int32(step), jnp.asarray(pl),
                         jnp.asarray(bt), 0.125)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)
    # The Pallas kernel takes P V of the tail slots with P rounded to the
    # tails' dtype (``p.astype(v.dtype)``, e4m3 or bf16), which the oracle,
    # the port's plain version and its kernel (bf16 P, as for the pages)
    # do not: within 5e-3 (measured 1.3e-3 on e4m3 tails).
    kern = jax_window_kernel(jnp.asarray(q), jc, jt[0], jt[1],
                             jnp.int32(LAYER), jnp.int32(step),
                             jnp.asarray(pl), jnp.asarray(bt), 0.125,
                             chunk_pages=2, interpret=True)
    live = pl > 0
    np.testing.assert_allclose(got[live], np.asarray(kern)[live], rtol=0,
                               atol=5e-3)


def test_e5m2_tails_are_bf16_and_that_shows():
    """The repaired fault: beside an e5m2 cache the tails are bf16 (the
    JAX runner keeps them so), which the port once allocated in e5m2.
    Tail values that e5m2 rounds and bf16 keeps move the window's output
    past the tolerance when the tail is e5m2."""
    q, jc, tc, jt, tt, bt, pl = _window_case("e5m2", seed=6)
    assert tt[0].dtype == torch.bfloat16
    step = 3
    want = np.asarray(jax_ref_window(
        jnp.asarray(q), jc[LAYER], jt[0][LAYER], jt[1][LAYER],
        jnp.int32(step), jnp.asarray(pl), jnp.asarray(bt), 0.125))
    got = window_decode_attention(T(q), tc, tt[0], tt[1], LAYER, step, T(pl),
                                  T(bt), 0.125).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    e5 = [t.to(torch.float8_e5m2).to(torch.bfloat16) for t in tt]
    assert not torch.equal(e5[0], tt[0])  # e5m2 rounds these values
    old = window_decode_attention(T(q), tc, e5[0], e5[1], LAYER, step,
                                  T(pl), T(bt), 0.125).numpy()
    assert np.abs(old - want).max() > 1e-3


@pytest.mark.parametrize("kind", ["e4m3", "e5m2"])
def test_runner_tails_follow_the_reference(kind):
    from aphrodite_tpu_torch import LLM
    hf = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
              num_attention_heads=4, num_key_value_heads=2,
              intermediate_size=64, architectures=["LlamaForCausalLM"])
    for dtype in ("float32", "bfloat16"):
        llm = LLM("t", hf_config=hf, tokenizer="unused", dtype=dtype,
                  device="cpu", num_kv_blocks=8, block_size=16,
                  kv_cache_dtype={"e4m3": "fp8_e4m3",
                                  "e5m2": "fp8_e5m2"}[kind])
        runner = llm.engine.core.worker.runner
        assert runner.kv_cache.dtype == F8[kind][1]
        assert runner.tail_dtype == {"e4m3": torch.float8_e4m3fn,
                                     "e5m2": torch.bfloat16}[kind]


@pytest.mark.parametrize("opts", [{}, {"sliding_window": 16},
                                  {"logits_soft_cap": 30.0}])
@pytest.mark.parametrize("kind", ["e4m3", "e5m2"])
def test_decode_fp8(kind, opts):
    rng = np.random.RandomState(2)
    sl = np.asarray([37, 1, 16, 70], np.int32)
    R, hd, mp = len(sl), 64, 6
    cache = (rng.randn(L, R * mp + 1, 2, KVH, PAGE, hd) * 0.5).astype(
        np.float32)
    jc, tc = _fp8_cache(cache, kind)
    bt = (1 + rng.permutation(R * mp)).reshape(R, mp).astype(np.int32)
    q = (rng.randn(R, NQ, hd) * 0.5).astype(np.float32)
    got = decode_paged_attention(T(q), tc, LAYER, T(bt), T(sl), hd ** -0.5,
                                 **opts).numpy()
    kern, _ = jax_decode_kernel(jnp.asarray(q), jc, jnp.asarray(bt),
                                jnp.asarray(sl), hd ** -0.5, chunk_pages=2,
                                interpret=True, layer_idx=LAYER, **opts)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=0, atol=1e-5)
    md = JaxMD(
        token_req_idx=jnp.arange(R, dtype=jnp.int32),
        token_pos=jnp.asarray(sl - 1), slot_mapping=jnp.full((R,), -1),
        query_start_loc=jnp.arange(R + 1, dtype=jnp.int32),
        seq_lens=jnp.asarray(sl), block_tables=jnp.asarray(bt),
        num_reqs=jnp.asarray(R, jnp.int32),
        num_tokens=jnp.asarray(R, jnp.int32), decode_mode=True)
    ref = jax_ref_ragged(jnp.asarray(q), jc[LAYER], md, hd ** -0.5, **opts)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("S", [32, 23])
@pytest.mark.parametrize("kind", ["e4m3", "e5m2"])
def test_shared_prefix_fp8(kind, S):
    rng = np.random.RandomState(S)
    hd, R = 64, 3
    cache = (rng.randn(L, 6, 2, KVH, PAGE, hd) * 0.3).astype(np.float32)
    jc, tc = _fp8_cache(cache, kind)
    q = (rng.randn(R, NQ, hd) * 0.3).astype(np.float32)
    pages = np.asarray([3, 1], np.int32)
    acc, m, lsum = cascade.shared_prefix_attention(T(q), tc, 1, T(pages), S,
                                                   0.1)
    jp = jnp.asarray([3, 1, 0, 0], jnp.int32)
    acc_k, m_k, l_k = jcascade.shared_prefix_attention(
        jnp.asarray(q), jc, jnp.asarray(1), jp, jnp.asarray(S), 0.1,
        chunk_pages=1, interpret=True)
    acc_r, m_r, l_r = jcascade.ref_shared_prefix_attention(
        jnp.asarray(q), jc[1], jp, S, 0.1)
    for a, mm, ll in ((acc_k, m_k[..., 0], l_k[..., 0]), (acc_r, m_r, l_r)):
        np.testing.assert_allclose(acc.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(m.numpy(), np.asarray(mm), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(lsum.numpy(), np.asarray(ll), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("group", [1, 4, 7])
def test_fp8_cache_launches_fit_an_h100(group, hd):
    # The tensor-core instances with their staging rings, and the CUDA-core
    # ones (their tiles in the cache's dtype), at every fp8 kind.
    for kv in (torch.float8_e4m3fn, torch.float8_e5m2):
        for dtype in (torch.bfloat16, torch.float32):
            _, _, smem = window_launch_geometry(dtype, group, hd,
                                                H100_SMEM_OPTIN, fp8=True)
            assert smem <= H100_SMEM_OPTIN
            _, _, smem = decode_launch_geometry(dtype, group, hd,
                                                H100_SMEM_OPTIN, kv)
            assert smem <= H100_SMEM_OPTIN
            assert ragged_work_item_tokens(dtype, group, hd,
                                           H100_SMEM_OPTIN, kv) >= 1
            plan = cascade.shared_prefix_plan(dtype, 4, 4 * group, 4, hd,
                                              1024, "cpu", kv)
            assert plan.smem <= H100_SMEM_OPTIN and plan.kv_dtype == kv


def test_mixed_cache_dtypes_raise():
    q = torch.zeros(1, NQ, 64)
    cache = torch.zeros(L, 2, 2, KVH, PAGE, 64, dtype=torch.float8_e5m2)
    tails = torch.zeros(L, 1, KVH, 4, 64)  # fp32: e5m2 takes bf16 tails
    with pytest.raises(ValueError):
        window_decode_attention(q, cache, tails, tails, 0, 0,
                                torch.ones(1, dtype=torch.int32),
                                torch.ones(1, 1, dtype=torch.int32), 0.1)


# --------------------------------------------------- the "fp8" layout
PATH = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
        "down": (14336, 4096)}  # a Llama-3.1-8B layer


@pytest.mark.parametrize("M", [1, 13, 32, 65, 128, 200, 256])
def test_fp8_schedule_writes_each_output_once(M):
    for K, N in (*PATH.values(), (1024, 1424)):
        for splits in (None, 3):
            p = w.plan("fp8", M, K, N, K, splits=splits)
            writes = np.zeros((M, N), np.int32)
            k_seen = {}
            for b in w.schedule("fp8", p, M, K, N):
                (m0, m1), (n0, n1), (r0, r1) = b["rows"], b["cols"], \
                    b["k_rows"]
                if not b["writes"]:
                    continue
                k_seen.setdefault((m0, n0), np.zeros(K, np.int32))[r0:r1] \
                    += 1
                if b["split"] == 0:
                    writes[m0:m1, n0:n1] += 1
            assert (writes == 1).all()
            assert all((v == 1).all() for v in k_seen.values())
    # One wave of blocks at M = 32, as "w8" (the same geometry).
    assert [w.plan("fp8", 32, K, N, K).splits for K, N in PATH.values()] \
        == [w.plan("w8", 32, K, N, K).splits for K, N in PATH.values()]


def test_fp8_layout_geometry_and_smem():
    assert w.byte_rows("fp8", 4096) == 4096 and w.x_boxes("fp8") == 1
    assert w.groups_per_stage("fp8", 4096, 4096) == 0
    assert w.fold_steps("fp8", 4096, 4096) == 4
    assert w.split_unit("fp8", 4096) == w.ROWS
    for mt in w.M_TILES:
        stages = w.ring_stages("fp8", mt, 0, 4)
        assert w.smem_bytes("fp8", mt, 0, 4, stages) <= H100_SMEM_OPTIN
        assert stages == w.ring_stages("w8", mt, 0, 4)


def test_fp8_conversion_is_exact_for_every_finite_byte():
    b = torch.arange(256, dtype=torch.int16).to(torch.uint8)
    finite = (b & 0x7F) != 0x7F
    got = w.fp8_model(b)
    want = b.view(torch.float8_e4m3fn).to(torch.bfloat16)
    assert torch.equal(got[finite].view(torch.int16),
                       want[finite].view(torch.int16))
    # +-448, +-2^-9 (the smallest subnormal) and +-0 among them
    v = got.float()
    for x in (448.0, -448.0, 2.0 ** -9, -(2.0 ** -9)):
        assert (v == x).any()


@pytest.mark.parametrize("splits", [None, 3])
@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("M,K,N", [(8, 2048, 256), (40, 1024, 128),
                                   (5, 96, 48)])
def test_fp8_fold_model_vs_plain_and_jax(M, K, N, rows, splits):
    x, w8, ws = _fp8_case(M, K, N, 0, seed=M + K)
    x = T(x).bfloat16().float()  # the kernel's x is bf16
    rs = T(np.random.RandomState(K).uniform(0.5, 2, M).astype(np.float32)) \
        if rows else None
    p = w.plan("fp8", M, K, N, K, splits=splits)
    q = to_torch(w8)
    got = w.fold_model("fp8", x, q, T(ws), None, p, row_scales=rs)
    plain = qm.ref_fp8_matmul(x, q, T(ws), rs)
    close(got.numpy(), plain.numpy())
    if not rows:  # the JAX function, weight-only
        close(got.numpy(), jgemm.fp8_matmul(jnp.asarray(x.numpy()),
                                            jnp.asarray(w8),
                                            jnp.asarray(ws)))


@pytest.mark.parametrize("bad", ["N%16", "int8 q", "row scales [M+1]",
                                 "zeros"])
def test_fp8_wrapper_raises_before_any_launch(bad):
    M, K, N = 4, 64, 32 if bad != "N%16" else 40
    x = torch.empty((M, K), dtype=torch.bfloat16, device="meta")
    q = torch.empty((K, N), device="meta",
                    dtype=torch.int8 if bad == "int8 q"
                    else torch.float8_e4m3fn)
    s = torch.empty((N,), dtype=torch.float32, device="meta")
    rs = torch.empty((M + 1 if bad.startswith("row") else M,),
                     dtype=torch.float32, device="meta")
    z = s if bad == "zeros" else None
    with pytest.raises(ValueError):
        w.check("fp8", x, q, s, z, rs)


def test_cpu_tensors_run_the_plain_fp8_version():
    x, w8, ws = _fp8_case(6, 64, 32, 0, seed=9)
    before = qm.fp8_matmul.launches
    got = qm.fp8_matmul(T(x), to_torch(w8), T(ws))
    assert qm.fp8_matmul.launches == before
    close(got.numpy(), qm.ref_fp8_matmul(T(x), to_torch(w8), T(ws)))


# ------------------------------------------------- weights carried over
def test_params_from_jax_takes_fp8_leaves_bit_for_bit():
    from aphrodite_tpu_torch.config import ModelConfig
    from aphrodite_tpu_torch.models.llama import LlamaForCausalLM
    H, I, V, Lm = 64, 96, 128, 2
    hf = dict(vocab_size=V, hidden_size=H, num_hidden_layers=Lm,
              num_attention_heads=4, num_key_value_heads=2,
              intermediate_size=I, architectures=["LlamaForCausalLM"])
    rng = np.random.RandomState(7)
    fp = lambda *s: (rng.randn(*s) * 0.02).astype(np.float32)  # noqa: E731
    hd = H // 4
    layers = {"input_norm": np.ones((Lm, H), np.float32),
              "post_norm": np.ones((Lm, H), np.float32),
              "wq": fp(Lm, H, H), "wk": fp(Lm, H, 2 * hd),
              "wv": fp(Lm, H, 2 * hd), "wo": fp(Lm, H, H),
              "w_gate": fp(Lm, H, I), "w_up": fp(Lm, H, I),
              "w_down": fp(Lm, I, H)}
    tree = quantize_stacked_params(
        {"embed": fp(V, H), "final_norm": np.ones(H, np.float32),
         "lm_head": fp(H, V), "layers": layers}, JaxQCfg.from_name("fp8"))
    assert tree["layers"]["wq"]["qweight"].dtype == ml_dtypes.float8_e4m3fn
    state = params_from_jax(tree)
    model = LlamaForCausalLM(ModelConfig("m", hf_config=hf),
                             quant_config=QuantizationConfig.from_name(
                                 "fp8"))
    load_params(model, state)
    jl = tree["layers"]
    for i, layer in enumerate(model.layers):
        qkv = np.concatenate([jl[k]["qweight"][i] for k in ("wq", "wk",
                                                            "wv")], -1)
        np.testing.assert_array_equal(
            layer.w_qkv.qweight.view(torch.uint8).numpy(),
            qkv.view(np.uint8))
        np.testing.assert_array_equal(
            layer.w_down.weight_scale.numpy(), jl["w_down"]["weight_scale"][i])
    with pytest.raises(ValueError):  # a value cast is refused
        bad = dict(state)
        k = next(n for n in bad if n.endswith("w_qkv.qweight"))
        bad[k] = bad[k].astype(np.float32)
        load_params(model, bad)
