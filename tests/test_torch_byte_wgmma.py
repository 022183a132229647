"""The bf16 one-byte-a-weight decode GEMMs (W8A16 and uint4 W4A16) checked
on the CPU: the "w8" and "uint4" layouts of ``ops/w4_wgmma.py`` (the
kernel, ``csrc/w4_wgmma.cu``, runs only on the card, where ``chip_smoke.py``
phase 2 holds it against its plain version).

- ``schedule`` writes every output exactly once and covers every byte row
  of W once per output tile, at M in {1, 5, 13, 32, 40, 65, 128, 200, 256}
  and the shapes of phase 15 (a Llama-3.1-8B layer's four GEMMs, W8) and
  phase 16 (a Qwen2.5-7B layer's, uint4), and at N = 1424;
- K splits fall on stage and group boundaries;
- every instance's shared memory fits an H100 (232,448 bytes);
- ``fold_model`` (uint4: each fold's k range, the zero after the product
  and inside it; w8: one scale a split) equals the plain versions and the
  Pallas kernels in interpret mode (``w4a16_matmul_pallas``,
  ``w8a16_matmul_pallas``) on the same numpy inputs, forced splits too;
- ``int8_model``, the kernel's conversion of a signed byte, is exact for
  all 256 byte values;
- the wrappers' contract (N a multiple of 16 and the rest);
- the prepared-launch cache is keyed on the tensors' version counters: an
  in-place load of the zeros (``worker.load_params``) changes the key and
  prepares the launch anew.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.ops.quant_matmul_pallas import (w4a16_matmul_pallas,
                                                   w8a16_matmul_pallas)
from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops import quant_matmul as qm
from aphrodite_tpu_torch.ops import w4_wgmma as w
from aphrodite_tpu_torch.ops.cuda_build import H100_SMEM_OPTIN

T = torch.from_numpy
LAYOUTS = ("uint4", "w8")
# (K, N) of a layer's four GEMMs (QKV and gate/up fused) on each path.
PATHS = {
    "w8": {"qkv": (4096, 6144), "o": (4096, 4096),
           "gate_up": (4096, 28672), "down": (14336, 4096)},
    "uint4": {"qkv": (3584, 4608), "o": (3584, 3584),
              "gate_up": (3584, 37888), "down": (18944, 3584)},
}
BATCHES = (1, 5, 13, 32, 40, 65, 128, 200, 256)


def _group(layout, K, group):
    return K if layout == "w8" else group


def covered(layout, M, K, N, group, splits=None):
    """How often the schedule writes each output and multiplies each
    (output tile, byte row)."""
    p = w.plan(layout, M, K, N, _group(layout, K, group), splits=splits)
    blocks = w.schedule(layout, p, M, K, N)
    writes = np.zeros((M, N), np.int32)
    k_seen = {}
    for b in blocks:
        (m0, m1), (n0, n1), (r0, r1) = b["rows"], b["cols"], b["k_rows"]
        assert r0 < r1 and r0 % w.ROWS == 0
        if not b["writes"]:
            assert n0 >= N
            continue
        k_seen.setdefault((m0, n0), np.zeros(K, np.int32))[r0:r1] += 1
        if b["split"] == 0:
            writes[m0:m1, n0:n1] += 1
    return p, blocks, writes, k_seen


@pytest.mark.parametrize("gemm", ["qkv", "o", "gate_up", "down"])
@pytest.mark.parametrize("M", BATCHES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_schedule_writes_each_output_once(layout, M, gemm):
    K, N = PATHS[layout][gemm]
    p, blocks, writes, k_seen = covered(layout, M, K, N, 128)
    assert (writes == 1).all()
    assert all((v == 1).all() for v in k_seen.values())
    assert p.mt * p.m_tiles >= M and p.m_tiles <= 2
    assert len(blocks) % w.CLUSTER == 0
    for a, b in zip(blocks[::2], blocks[1::2]):
        assert (a["rank"], b["rank"]) == (0, 1)
        assert a["rows"] == b["rows"] and a["k_rows"] == b["k_rows"]


@pytest.mark.parametrize("splits", [None, 1, 3, 7])
@pytest.mark.parametrize("M", [13, 128, 200])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_schedule_at_a_ragged_n_and_forced_splits(layout, M, splits):
    # N = 1424: 12 column tiles, the last 16 wide; K = 1024 byte rows.
    p, _, writes, k_seen = covered(layout, M, 1024, 1424, 64, splits)
    assert (writes == 1).all()
    assert all((v == 1).all() for v in k_seen.values())


@pytest.mark.parametrize("layout,M,want", [
    ("w8", 32, [2, 4, 1, 4]), ("w8", 128, [2, 4, 1, 4]),
    ("uint4", 32, [3, 4, 1, 4]), ("uint4", 256, [1, 2, 1, 2])])
def test_splits_fill_one_wave(layout, M, want):
    # The plan splits K only as far as one wave of blocks: the splits that
    # timed fastest at each path's shapes (PERF.md); gate_up's
    # column tiles alone fill the card.
    got = []
    for K, N in PATHS[layout].values():
        p = w.plan(layout, M, K, N, _group(layout, K, 128))
        blocks = -(-N // w.BN // w.CLUSTER) * w.CLUSTER * p.m_tiles
        assert p.splits == 1 or blocks * p.splits <= 132
        got.append(p.splits)
    assert got == want


@pytest.mark.parametrize("group", [32, 64, 96, 128])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_splits_fall_on_stage_and_group_boundaries(layout, group):
    K, N = 18816, 3584  # K a multiple of 96 and of 128
    for splits in (None, 2, 3, 5, 16):
        p = w.plan(layout, 32, K, N, _group(layout, K, group), splits=splits)
        assert p.chunk_rows % w.ROWS == 0
        if layout == "uint4":  # one byte row a k: whole groups
            assert p.chunk_rows % group == 0
        assert (p.splits - 1) * p.chunk_rows < K <= p.splits * p.chunk_rows


def test_byte_layout_geometry():
    # One byte row a k: a 64-row stage is 64 k, one x box, one half; w8
    # stages no scales (its epilogue reads s [N]) and folds once a stage.
    for layout in LAYOUTS:
        assert w.byte_rows(layout, 4096) == 4096
        assert w.x_boxes(layout) == 1 and w.halves(layout) == 1
        assert w.half_ranges(layout, 4096, 64, 64) == [(64, 128)]
    assert w.groups_per_stage("w8", 4096, 4096) == 0
    assert w.split_unit("w8", 4096) == w.ROWS
    assert w.fold_steps("w8", 4096, 4096) == 4
    assert w.groups_per_stage("uint4", 4096, 128) == 1
    assert w.groups_per_stage("uint4", 4032, 96) == 2
    assert [w.fold_steps("uint4", 4096, g) for g in (32, 64, 96, 128)] \
        == [2, 4, 2, 4]
    assert w.ZERO_BASE[torch.bfloat16]["uint4"] == 128.0
    assert w.ZERO_BASE[torch.float16]["uint4"] == 1024.0


FOLDS = {"uint4": (2, 4), "w8": (4,)}  # the kernel's instances


@pytest.mark.parametrize("layout", LAYOUTS)
def test_every_instance_fits_an_h100(layout):
    for mt in w.M_TILES:
        for fold in FOLDS[layout]:
            for gs in ((0,) if layout == "w8" else (1, 2, 3, 4, 5)):
                stages = w.ring_stages(layout, mt, gs, fold)
                assert 2 <= stages <= w.MAX_STAGES
                assert w.smem_bytes(layout, mt, gs, fold, stages) \
                    <= H100_SMEM_OPTIN
                assert stages * w.stage_bytes(layout, mt, gs, fold) >= \
                    2 * mt * w.PITCH * 4
                assert w.stage_bytes(layout, mt, gs, fold) % 1024 == 0
                # A forced depth never passes what fits.
                deep = w.ring_stages(layout, mt, gs, fold, most=32)
                assert w.smem_bytes(layout, mt, gs, fold, deep) \
                    <= H100_SMEM_OPTIN < \
                    w.smem_bytes(layout, mt, gs, fold, deep + 1)


# ------------------------------------------------------------- arithmetic
def _case(layout, M, K, N, group, seed, frac=False):
    """x, q (int8 [K, N]), s, z (None for w8) as numpy, the int8 bytes
    holding -128 and 127 in every column."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    if layout == "w8":
        q = rng.integers(-128, 128, size=(K, N)).astype(np.int8)
        q[0], q[1] = -128, 127
        return x, q, rng.uniform(0.5, 1.5, size=N).astype(np.float32), None
    G = K // group
    q = rng.integers(0, 16, size=(K, N)).astype(np.int8)
    s = rng.uniform(0.5, 1.5, size=(G, N)).astype(np.float32)
    z = rng.integers(0, 16, size=(G, N)).astype(np.float32)
    return x, q, s, (z + 0.37 if frac else z)


def _plain(layout, x, q, s, z):
    if layout == "w8":
        return qm.ref_w8a16_matmul(T(x), T(q), T(s))
    return qm.ref_w4a16_matmul(T(x), T(q), T(s), T(z))


def _pallas(layout, x, q, s, z):
    if layout == "w8":
        return np.asarray(w8a16_matmul_pallas(
            jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), block_n=128,
            block_k=512, interpret=True))
    return np.asarray(w4a16_matmul_pallas(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(z),
        block_n=128, block_k=512, interpret=True))


@pytest.mark.parametrize("splits", [None, 3])
@pytest.mark.parametrize("M,K,N,group", [(8, 2048, 256, 128),
                                         (40, 1024, 128, 64),
                                         (5, 2048, 192, 32)])
@pytest.mark.parametrize("layout,zero_in", [("uint4", False),
                                            ("uint4", True),
                                            ("w8", True)])  # w8: no zeros
def test_fold_model_vs_plain_and_pallas(layout, zero_in, M, K, N, group,
                                        splits):
    x, q, s, z = _case(layout, M, K, N, group, seed=M + K + group)
    p = w.plan(layout, M, K, N, _group(layout, K, group), splits=splits)
    got = w.fold_model(layout, T(x), T(q), T(s),
                       None if z is None else T(z), p, zero_in).numpy()
    plain = _plain(layout, x, q, s, z).numpy()
    # Both in fp32, the sums in another order: within 1e-5 of the scale.
    np.testing.assert_allclose(got, plain, rtol=0,
                               atol=1e-5 * np.abs(plain).max())
    # tests/test_torch_quant.py's tolerance for the Pallas kernels, which
    # take the products in bf16-free fp32 in another order.
    np.testing.assert_allclose(got, _pallas(layout, x, q, s, z), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("zero_in", [False, True])
@pytest.mark.parametrize("K,group", [(96, 32), (4032, 96), (1088, 64)])
def test_fold_model_uint4_short_last_stage(K, group, zero_in):
    # K no multiple of a stage's 64 rows, or a group that straddles stages:
    # the last stage runs whole on zero-filled rows, a fold stays in its
    # group; the kernel's x is bf16.
    M, N = 7, 48
    x, q, s, z = _case("uint4", M, K, N, group, seed=K)
    xb = T(x).bfloat16().float()
    p = w.plan("uint4", M, K, N, group)
    got = w.fold_model("uint4", xb, T(q), T(s), T(z), p, zero_in)
    plain = qm.ref_w4a16_matmul(xb, T(q), T(s), T(z))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=1e-5 * plain.abs().max().item())


def test_fractional_zeros_keep_the_sums_form():
    x, q, s, z = _case("uint4", 16, 1024, 64, 128, seed=11, frac=True)
    assert not w.zeros_integral("uint4", T(z))
    assert w.zeros_integral("uint4", T(np.round(z)))
    assert not w.zeros_integral("uint4", T(np.round(z) + 200.0))
    for splits in (None, 3):
        p = w.plan("uint4", 16, 1024, 64, 128, splits=splits)
        got = w.fold_model("uint4", T(x), T(q), T(s), T(z), p)
        plain = _plain("uint4", x, q, s, z)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                                   atol=1e-5 * plain.abs().max().item())
        np.testing.assert_allclose(got.numpy(),
                                   _pallas("uint4", x, q, s, z),
                                   rtol=2e-2, atol=2e-2)


def test_int8_conversion_is_exact_for_every_byte():
    b = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    got = w.int8_model(b)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), b.float())
    # The magic number: the fp32 of 0x4B000000 | (b ^ 0x80) is 2^23 + 128
    # + b, exact (the byte fills the low mantissa bits).
    bits = 0x4B000000 | ((b.to(torch.int32) & 0xFF) ^ 0x80)
    assert torch.equal(bits.view(torch.float32).double(),
                       2.0 ** 23 + 128 + b.double())


def test_uint4_conversion_matches_the_packed_low_nibble():
    # uint4's byte is packed's low-nibble pass: 0x4300 | u is 128 + u.
    u = torch.arange(16, dtype=torch.int16)
    v = (u | 0x4300).view(torch.bfloat16).float()
    assert torch.equal(v - 128.0, u.float())


# ------------------------------------------------------------- the wrappers
def _meta(layout, M=32, K=256, N=128, group=64, x_dtype=torch.bfloat16,
          q_rows=None, scales=None):
    x = torch.empty((M, K), dtype=x_dtype, device="meta")
    q = torch.empty((K if q_rows is None else q_rows, N), dtype=torch.int8,
                    device="meta")
    if layout == "w8":
        s = torch.empty(scales or (N,), dtype=torch.float32, device="meta")
        return x, q, s, None
    s = torch.empty(scales or (K // group, N), dtype=torch.float32,
                    device="meta")
    return x, q, s, torch.empty_like(s)


@pytest.mark.parametrize("M,K,N,group", [(1, 32, 16, 32),
                                         (256, 4096, 28672, 128),
                                         (32, 18944, 3584, 128),
                                         (5, 96, 1424, 32)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_wrapper_takes(layout, M, K, N, group):
    want = K if layout == "w8" else group
    assert w.check(layout, *_meta(layout, M, K, N, group)) == want


_BAD = ["M=0", "M=257", "K%32", "N%16", "N%4 only", "fp32 x", "q rows",
        "scales"]


@pytest.mark.parametrize("fn,bad", [("w8a16_matmul", b) for b in _BAD]
                         + [("w4a16_matmul", b) for b in _BAD + ["group%32"]])
def test_wrapper_raises_before_any_launch(fn, bad):
    layout = "w8" if fn == "w8a16_matmul" else "uint4"
    kw = {"M=0": dict(M=0), "M=257": dict(M=257), "K%32": dict(K=48,
                                                               group=16),
          "N%16": dict(N=24), "N%4 only": dict(N=1420),
          "group%32": dict(group=16), "fp32 x": dict(x_dtype=torch.float32),
          "q rows": dict(q_rows=128), "scales": dict(scales=(3, 128))}
    args = _meta(layout, **kw[bad])
    if bad == "fp32 x":  # fp32 has its own kernel: only the bf16 check
        with pytest.raises(ValueError):
            w.check(layout, *args)
        return
    launches = qm.KERNELS[fn].launches
    with pytest.raises(ValueError, match="N of 16" if "N%" in bad else None):
        qm.KERNELS[fn](*(a for a in args if a is not None))
    assert qm.KERNELS[fn].launches == launches


@pytest.mark.parametrize("layout", LAYOUTS)
def test_cpu_tensors_run_the_plain_version(layout):
    x, q, s, z = _case(layout, 9, 256, 64, 64, seed=3)
    xb = T(x).bfloat16()
    fn = qm.KERNELS["w8a16_matmul" if layout == "w8" else "w4a16_matmul"]
    before = fn.launches
    args = (T(q), T(s)) if layout == "w8" else (T(q), T(s), T(z))
    got = fn(xb, *args)
    assert fn.launches == before and got.dtype == torch.bfloat16
    want = (qm.ref_w8a16_matmul(xb, *args) if layout == "w8"
            else qm.ref_w4a16_matmul(xb, *args))
    assert torch.equal(got, want)


# ------------------------------------------------------- the launch cache
def test_call_key_follows_in_place_writes():
    x, q, s, z = (T(a) for a in _case("uint4", 4, 256, 64, 64, seed=5)[:4])
    xb = x.bfloat16()
    key = w.call_key("uint4", xb, q, s, z, None)
    assert w.call_key("uint4", xb, q, s, z, None) == key
    z.add_(0.5)  # the zeros' values, and with them the form, change
    assert w.call_key("uint4", xb, q, s, z, None) != key
    key = w.call_key("uint4", xb, q, s, z, None)
    s.mul_(2.0)
    assert w.call_key("uint4", xb, q, s, z, None) != key
    # w8 has no zeros.
    q8, s8 = T(np.zeros((256, 64), np.int8)), T(np.ones(64, np.float32))
    assert w.call_key("w8", xb, q8, s8, None)[-1] is None


def test_launch_is_prepared_anew_after_an_in_place_load(monkeypatch):
    # matmul's cache on the CPU, with the launch itself stubbed: a second
    # call reuses the prepared launch; an in-place write to the zeros
    # prepares it again, reading the zeros' form anew.
    prepared = []

    def fake_prepare(layout, x, q, scales, zeros, splits, lib, zero_in,
                     stages):
        prepared.append(w.zeros_integral(layout, zeros))
        return ((lambda *a: 0), None, None, w.plan(layout, *x.shape,
                                                   q.shape[1], 64),
                q.shape[1], None, "stub", None)

    monkeypatch.setattr(w, "_prepare", fake_prepare)
    monkeypatch.setattr(cuda_build, "stream", lambda dev: 0)
    monkeypatch.setattr(w, "_CALLS", {})
    x, q, s, z = (T(a) for a in _case("uint4", 4, 256, 64, 64, seed=6)[:4])
    xb = x.bfloat16()
    for _ in range(2):
        w.matmul("uint4", xb, q, s, z)
    assert prepared == [True]
    z.add_(0.37)
    w.matmul("uint4", xb, q, s, z)
    assert prepared == [True, False]


def test_worker_load_params_changes_the_key():
    # A quantized model on the CPU: load_params rewrites a projection's
    # zeros in place (same tensor, same address); the key must move.
    from aphrodite_tpu_torch import LLM
    cfg = dict(vocab_size=128, hidden_size=128, num_hidden_layers=1,
               num_attention_heads=2, num_key_value_heads=1,
               intermediate_size=256, architectures=["Qwen2ForCausalLM"])
    llm = LLM("tiny", hf_config=cfg, tokenizer="unused", dtype="float32",
              device="cpu", quantization="gptq", block_size=16,
              num_kv_blocks=32, max_num_seqs=2, max_num_batched_tokens=32,
              max_model_len=64)
    worker = llm.engine.core.worker
    leaf = worker.model.layers[0].w_qkv
    x = torch.zeros((4, leaf.scales.shape[0] * 128), dtype=torch.bfloat16)
    ptr = leaf.zeros.data_ptr()
    key = w.call_key("uint4", x, leaf.qweight, leaf.scales, leaf.zeros)
    state = {k: v.numpy().copy() for k, v in
             worker.model.state_dict().items()}
    state["layers.0.w_qkv.zeros"] = state["layers.0.w_qkv.zeros"] + 0.5
    worker.load_params(state)
    assert leaf.zeros.data_ptr() == ptr
    assert w.call_key("uint4", x, leaf.qweight, leaf.scales,
                      leaf.zeros) != key
