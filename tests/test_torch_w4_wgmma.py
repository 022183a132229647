"""The bf16 W4A16 decode GEMMs' launch and arithmetic, checked on the CPU
(``ops/w4_wgmma.py``; the kernel, ``csrc/w4_wgmma.cu``, runs only on the
card, where ``chip_smoke.py`` phase 2 holds it against its plain version).

- ``schedule``, the kernel's blocks in its own arithmetic, writes every
  output exactly once and covers every byte row of W once per output
  tile, at M in {1, 5, 13, 32, 40, 65, 128, 200, 256} and the Llama-3.1-8B
  layer's four GEMMs (the int4 and the packed path's shapes), and at an N
  that is no multiple of 128;
- K splits fall on stage and group boundaries;
- every instance's shared memory fits an H100 (232,448 bytes);
- ``fold_model``, the kernel's group-wise arithmetic (each fold's k range,
  the packed layout's halves folded apart; the zero as the TPU kernel
  takes it, after the product, and inside it), equals the plain versions
  and the Pallas kernels in interpret mode on the same numpy inputs;
  ``zeros_integral`` picks the form;
- the wrappers' shape contract: what they take, what they raise on, and
  that CPU tensors run the plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.ops.quant_matmul_pallas import (
    w4a16_int4_matmul_pallas, w4a16_packed_matmul_pallas)
from aphrodite_tpu_torch.ops import quant_matmul as qm
from aphrodite_tpu_torch.ops import w4_wgmma as w
from aphrodite_tpu_torch.ops.cuda_build import H100_SMEM_OPTIN, H100_SMS

T = torch.from_numpy
# (K, N) of a Llama-3.1-8B layer's four GEMMs (QKV and gate/up fused): the
# shapes of both the packed (phase 6) and the int4 (phase 14) path.
LLAMA8B = {"qkv": (4096, 6144), "o": (4096, 4096),
           "gate_up": (4096, 28672), "down": (14336, 4096)}
BATCHES = (1, 5, 13, 32, 40, 65, 128, 200, 256)


def covered(layout, M, K, N, group, splits=None, sms=H100_SMS):
    """Count, from the schedule, how often each output is written and how
    often each (output tile, byte row) is multiplied."""
    p = w.plan(layout, M, K, N, group, sms=sms, splits=splits)
    blocks = w.schedule(layout, p, M, K, N)
    writes = np.zeros((M, N), np.int32)
    k_seen = {}
    for b in blocks:
        (m0, m1), (n0, n1), (r0, r1) = b["rows"], b["cols"], b["k_rows"]
        assert r0 < r1 and r0 % w.ROWS == 0
        if not b["writes"]:
            assert n0 >= N
            continue
        key = (m0, n0)
        k_seen.setdefault(key, np.zeros(K // 2, np.int32))[r0:r1] += 1
        # Unsplit, each block writes its tile; split, the last block of the
        # tile writes it once for all splits (counted at split 0).
        if b["split"] == 0:
            writes[m0:m1, n0:n1] += 1
    return p, blocks, writes, k_seen


@pytest.mark.parametrize("gemm", sorted(LLAMA8B))
@pytest.mark.parametrize("M", BATCHES)
@pytest.mark.parametrize("layout", ["int4", "packed"])
def test_schedule_writes_each_output_once(layout, M, gemm):
    K, N = LLAMA8B[gemm]
    p, blocks, writes, k_seen = covered(layout, M, K, N, 128)
    assert (writes == 1).all()
    assert all((v == 1).all() for v in k_seen.values())
    assert p.mt * p.m_tiles >= M and p.m_tiles <= 2
    # Both blocks of a cluster share the M tile and the K split, so that
    # one x box serves both.
    assert len(blocks) % w.CLUSTER == 0
    for a, b in zip(blocks[::2], blocks[1::2]):
        assert (a["rank"], b["rank"]) == (0, 1)
        assert a["rows"] == b["rows"] and a["k_rows"] == b["k_rows"]
        assert b["tile"] == a["tile"] + 1


@pytest.mark.parametrize("splits", [None, 1, 3, 7])
@pytest.mark.parametrize("M", [13, 128, 200])
@pytest.mark.parametrize("layout", ["int4", "packed"])
def test_schedule_at_a_ragged_n_and_forced_splits(layout, M, splits):
    # N = 1424: 12 column tiles, the last 16 columns wide; 6 clusters.
    K, N = 1024, 1424
    p, blocks, writes, k_seen = covered(layout, M, K, N, 64, splits=splits)
    assert (writes == 1).all()
    assert all((v == 1).all() for v in k_seen.values())
    if splits is not None:  # as many as K's units split evenly allow
        units = -(-(K // 2) // w.split_unit(layout, 64))
        assert p.splits == -(-units // -(-units // splits))


def test_odd_tile_count_partner_writes_nothing():
    # N = 1152: 9 column tiles, so the last cluster's second block lies past
    # N; it still loads (its partner needs its half of x) but writes nothing.
    p = w.plan("int4", 32, 1024, 1152, 128)
    blocks = w.schedule("int4", p, 32, 1024, 1152)
    idle = [b for b in blocks if not b["writes"]]
    assert idle and all(b["tile"] == 9 and b["rank"] == 1 for b in idle)


@pytest.mark.parametrize("group", [32, 64, 128, 256])
@pytest.mark.parametrize("layout", ["int4", "packed"])
def test_splits_fall_on_stage_and_group_boundaries(layout, group):
    K, N = 14336, 4096
    g_rows = group // 2 if layout == "int4" else group
    for splits in (None, 2, 3, 5, 16):
        p = w.plan(layout, 32, K, N, group, splits=splits)
        assert p.chunk_rows % w.ROWS == 0 and p.chunk_rows % g_rows == 0
        assert (p.splits - 1) * p.chunk_rows < K // 2 <= \
            p.splits * p.chunk_rows
    # A forced count above what K holds is cut to one split a unit.
    p = w.plan(layout, 32, 1024, 256, group, splits=1000)
    assert p.splits == -(-(1024 // 2) // w.split_unit(layout, group))


FOLDS = {"int4": (2, 4, 8), "packed": (1, 2, 4)}  # the kernel's instances


@pytest.mark.parametrize("layout", ["int4", "packed"])
def test_every_instance_fits_an_h100(layout):
    for mt in w.M_TILES:
        for fold in FOLDS[layout]:
            for gs in (1, 2, 3, 4, 5):
                stages = w.ring_stages(layout, mt, gs, fold)
                assert 2 <= stages <= w.MAX_STAGES
                assert w.smem_bytes(layout, mt, gs, fold, stages) \
                    <= H100_SMEM_OPTIN
                # The epilogue's two fp32 tiles reuse the ring.
                assert stages * w.stage_bytes(layout, mt, gs, fold) >= \
                    2 * mt * w.PITCH * 4
                assert w.stage_bytes(layout, mt, gs, fold) % 1024 == 0
    # At M tile 128 a stage is ~43 KB: five fit, a sixth would not.
    fold = w.half_steps(layout)
    assert w.ring_stages(layout, 128, 1, fold) == 5
    assert w.smem_bytes(layout, 128, 1, fold, 6) > H100_SMEM_OPTIN


@pytest.mark.parametrize("layout,K,group,want", [
    ("int4", 4096, 128, 8), ("int4", 4096, 256, 8), ("int4", 4096, 64, 4),
    ("int4", 4096, 32, 2), ("int4", 4032, 96, 2), ("packed", 4096, 128, 4),
    ("packed", 4096, 32, 2), ("packed", 96, 32, 1), ("packed", 2112, 64, 2)])
def test_fold_steps(layout, K, group, want):
    f = w.fold_steps(layout, K, group)
    assert f == want and f in FOLDS[layout]
    # Every fold of every stage lies within one group.
    for r0 in range(0, K // 2, w.ROWS):
        for k0, k1 in w.half_ranges(layout, K, r0, w.ROWS):
            for a in range(k0, k1, 16 * f):
                assert a // group == (a + 16 * f - 1) // group


@pytest.mark.parametrize("layout,K,group,want", [
    ("int4", 4096, 128, 1), ("int4", 4096, 32, 4), ("int4", 4096, 256, 1),
    ("packed", 4096, 128, 1), ("packed", 4096, 32, 2),
    # K/2 = 48 is no multiple of the group: the high half's stages straddle
    # (a short last stage runs whole: its rows past K/2 read zeros)
    ("packed", 96, 32, 3), ("packed", 2112, 64, 2)])
def test_groups_per_stage(layout, K, group, want):
    assert w.groups_per_stage(layout, K, group) == want


# ------------------------------------------------------------- arithmetic
def _case(layout, M, K, N, group, seed):
    rng = np.random.default_rng(seed)
    G = K // group
    x = rng.normal(size=(M, K)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, size=(G, N)).astype(np.float32)
    if layout == "int4":
        q = rng.integers(-8, 8, size=(K, N)).astype(np.int8)
        z = rng.integers(-8, 8, size=(G, N)).astype(np.float32)
        qb = qm.pack_int4(T(q))
    else:
        q = rng.integers(0, 16, size=(K, N)).astype(np.int8)
        z = rng.integers(0, 16, size=(G, N)).astype(np.float32)
        qb = T((q[:K // 2].astype(np.uint8)
                | (q[K // 2:].astype(np.uint8) << 4)))
    return x, q, qb, s, z


def _plain(layout, x, qb, s, z):
    ref = (qm.ref_w4a16_int4_matmul if layout == "int4"
           else qm.ref_w4a16_packed_matmul)
    return ref(x, qb, s, z)


@pytest.mark.parametrize("zero_in", [False, True])
@pytest.mark.parametrize("splits", [None, 3])
@pytest.mark.parametrize("M,K,N,group", [(8, 2048, 256, 128),
                                         (40, 2048, 128, 64),
                                         (5, 4096, 192, 256)])
@pytest.mark.parametrize("layout", ["int4", "packed"])
def test_fold_model_vs_plain_and_pallas(layout, M, K, N, group, splits,
                                        zero_in):
    x, q, qb, s, z = _case(layout, M, K, N, group, seed=M + K)
    p = w.plan(layout, M, K, N, group, splits=splits)
    assert w.zeros_integral(layout, T(z))
    got = w.fold_model(layout, T(x), qb, T(s), T(z), p, zero_in).numpy()
    plain = _plain(layout, T(x), qb, T(s), T(z)).numpy()
    # Both in fp32, the sums in another order: within 1e-5 of the scale.
    np.testing.assert_allclose(got, plain, rtol=0,
                               atol=1e-5 * np.abs(plain).max())
    if layout == "int4":
        kern = np.asarray(w4a16_int4_matmul_pallas(
            jnp.asarray(x), jnp.asarray(q).astype(jnp.int4), jnp.asarray(s),
            jnp.asarray(z), block_n=128, block_k=512, interpret=True))
        # tests/test_torch_int4.py's tolerance
        np.testing.assert_allclose(got, kern, rtol=2e-4, atol=2e-3)
    elif (K // 2) % (8 * group) == 0:  # the shapes the Pallas kernel takes
        kern = np.asarray(w4a16_packed_matmul_pallas(
            jnp.asarray(x), jnp.asarray(qb.numpy().view(np.int8)),
            jnp.asarray(s), jnp.asarray(z), block_k=K // 2, block_n=128,
            interpret=True))
        # tests/test_torch_quant.py's tolerance for the packed kernel
        np.testing.assert_allclose(got, kern, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("zero_in", [False, True])
@pytest.mark.parametrize("K,group", [(96, 32), (2112, 64), (1024, 32)])
def test_fold_model_packed_halves_fold_apart(K, group, zero_in):
    # Where K/2 is no multiple of the group the high half's groups start
    # mid-stage: each half is cut at its own boundaries.
    M, N = 7, 48
    x, q, qb, s, z = _case("packed", M, K, N, group, seed=K)
    xb = torch.from_numpy(x).bfloat16().float()  # the kernel's x is bf16
    p = w.plan("packed", M, K, N, group)
    got = w.fold_model("packed", xb, qb, T(s), T(z), p, zero_in)
    plain = qm.ref_w4a16_packed_matmul(xb, qb, T(s), T(z))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=1e-5 * plain.abs().max().item())


@pytest.mark.parametrize("layout", ["int4", "packed"])
def test_fractional_zeros_keep_the_sums_form(layout):
    # A zero that is no integer makes q - z inexact in bf16: the kernel then
    # takes the TPU kernel's form, whose model still equals the plain
    # version; zeros past the bf16-exact range do the same.
    x, q, qb, s, z = _case(layout, 16, 1024, 64, 128, seed=11)
    zf = z + 0.37
    assert not w.zeros_integral(layout, T(zf))
    assert not w.zeros_integral(layout, T(z + 200.0))
    p = w.plan(layout, 16, 1024, 64, 128)
    got = w.fold_model(layout, T(x), qb, T(s), T(zf), p)
    plain = _plain(layout, T(x), qb, T(s), T(zf))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=1e-5 * plain.abs().max().item())


# ------------------------------------------------------------- the wrappers
def _meta(M=32, K=256, N=128, group=64, x_dtype=torch.bfloat16,
          q_rows=None):
    G = K // group
    x = torch.empty((M, K), dtype=x_dtype, device="meta")
    q = torch.empty((K // 2 if q_rows is None else q_rows, N),
                    dtype=torch.uint8, device="meta")
    s = torch.empty((G, N), dtype=torch.float32, device="meta")
    return x, q, s, torch.empty_like(s)


@pytest.mark.parametrize("layout", ["int4", "packed"])
@pytest.mark.parametrize("M,K,N,group", [(1, 32, 16, 32), (256, 4096, 28672,
                                                           128),
                                         (200, 14336, 4096, 256),
                                         (5, 96, 1424, 32)])
def test_wrapper_takes(layout, M, K, N, group):
    assert w.check(layout, *_meta(M, K, N, group)) == group


@pytest.mark.parametrize("bad", ["M=0", "M=257", "K%32", "N%16", "group%32",
                                 "fp32 x", "q rows"])
@pytest.mark.parametrize("fn", ["w4a16_int4_matmul", "w4a16_packed_matmul"])
def test_wrapper_raises_before_any_launch(fn, bad):
    kw = {"M=0": dict(M=0), "M=257": dict(M=257), "K%32": dict(K=48,
                                                               group=16),
          "N%16": dict(N=24), "group%32": dict(group=16),
          "fp32 x": dict(x_dtype=torch.float32), "q rows": dict(q_rows=64)}
    args = _meta(**kw[bad])
    if bad == "fp32 x":  # fp32 has its own kernel: only the bf16 check
        with pytest.raises(ValueError):
            w.check("int4", *args)
        return
    with pytest.raises(ValueError):
        getattr(qm, fn)(*args)


@pytest.mark.parametrize("layout", ["int4", "packed"])
def test_cpu_tensors_run_the_plain_version(layout):
    x, q, qb, s, z = _case(layout, 9, 256, 64, 64, seed=3)
    xb = T(x).bfloat16()
    fn = qm.KERNELS[f"w4a16_{layout}_matmul"]
    before = fn.launches
    got = fn(xb, qb, T(s), T(z))
    assert fn.launches == before and got.dtype == torch.bfloat16
    assert torch.equal(got, _plain(layout, xb, qb, T(s), T(z)))
