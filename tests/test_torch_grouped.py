"""The bf16 grouped GEMM's launch, checked on the CPU (ops/grouped_matmul.py).

The kernel itself runs only on the card (``chip_smoke.py`` phase 2 holds it
against its plain version). Here:
- ``grouped_schedule``, the kernel's tile schedule in its own arithmetic
  (clusters of two blocks on consecutive work items, ``find_item``'s
  32-expert chunks), writes every (row, column) of y exactly once, with the
  right group, and each cluster stops at the first pair without work;
- the launch fits an H100's shared memory;
- CPU tensors take the plain version, which matches megablox ``gmm``
  (interpret mode) in bf16, and never touch the launch counter;
- the wrapper raises on what the kernel cannot take.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu_torch.ops.cuda_build import H100_SMEM_OPTIN
from aphrodite_tpu_torch.ops.grouped_matmul import (BM, BN, CLUSTER,
                                                    grouped_matmul,
                                                    grouped_schedule,
                                                    grouped_smem_bytes,
                                                    ref_grouped_matmul)


def random_sizes(seed: int, M: int, E: int) -> list[int]:
    return np.random.RandomState(seed).multinomial(
        M, np.ones(E) / E).tolist()


SCHEDULE_CASES = {  # group sizes
    "empty-groups": [0, 300, 0, 0, 129, 0, 250, 0],
    "one-group-most": [3, 2000, 0, 7],
    "rows-of-one": [1] * 40,
    "smaller-than-a-tile": [20, 45, 13, 50, 60, 1],
    "M-below-BM": [30, 0, 40],
    "M-not-a-tile-multiple": [257, 300, 443],
    "E33": random_sizes(1, 3000, 33),
    "E60": random_sizes(2, 4000, 60),
    "E64": random_sizes(3, 2500, 64),
    "E65": random_sizes(4, 5000, 65),
    "E65-sparse": [0] * 31 + [700] + [0] * 32 + [90],
}


def items_in_order(off: np.ndarray, M: int, bm: int) -> list:
    """The work items written out plainly: each group's row tiles in
    order, groups in order, empty groups none."""
    out = []
    for e in range(len(off) - 1):
        lo, hi = int(off[e]), int(off[e + 1])
        r = lo
        while r < hi:
            end = min((r // bm + 1) * bm, hi)
            out.append((e, r, end))
            r = end
    return out


@pytest.mark.parametrize("grid", [1, 7, 132])
@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES))
def test_schedule_writes_y_once(case, grid):
    sizes = SCHEDULE_CASES[case]
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    M, E, N = int(off[-1]), len(sizes), 600  # N: 3 tiles, the last ragged
    visits = grouped_schedule(off, M, E, N, grid=grid)
    group_of = np.repeat(np.arange(E), sizes)
    seen = np.zeros((M, N), np.int32)
    for blk in visits:
        for g, lo, hi, n0 in blk:
            assert 0 <= lo < hi <= M and lo // BM == (hi - 1) // BM
            assert (group_of[lo:hi] == g).all()
            seen[lo:hi, n0:n0 + BN] += 1
    assert (seen == 1).all()

    # Each cluster visits exactly the pair tiles whose first item has work,
    # in the order the kernel takes them, and then stops.
    items = items_in_order(off, M, BM)
    n_tiles = -(-N // BN)
    max_tiles = -(-(-(-M // BM) + E - 1) // CLUSTER) * n_tiles
    clusters = len(visits) // CLUSTER
    assert len(visits) % CLUSTER == 0 and clusters <= max(1, grid // 2)
    for cid in range(clusters):
        for r in range(CLUSTER):
            want = [(*items[CLUSTER * (u // n_tiles) + r],
                     (u % n_tiles) * BN)
                    for u in range(cid, max_tiles, clusters)
                    if CLUSTER * (u // n_tiles) + r < len(items)]
            assert visits[CLUSTER * cid + r] == want


def test_launch_fits_an_h100():
    need = grouped_smem_bytes()
    assert need == 3 * 48 * 1024 + 64 * 1024 + 48 + 1024
    assert need <= H100_SMEM_OPTIN
    # A fourth stage beside y's slabs would not fit.
    assert grouped_smem_bytes(stages=4) > H100_SMEM_OPTIN


@pytest.mark.parametrize("sizes", [[20, 0, 45, 13, 0, 50], [1, 126, 1]])
def test_cpu_bf16_takes_the_plain_version(sizes):
    from jax.experimental.pallas.ops.tpu.megablox import gmm
    E, M, K, N = len(sizes), sum(sizes), 64, 96
    rng = np.random.RandomState(5)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(E, K, N) / np.sqrt(K)).astype(np.float32)
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    before = grouped_matmul.launches
    got = grouped_matmul(xb, wb, torch.from_numpy(off))
    assert grouped_matmul.launches == before
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref_grouped_matmul(xb, wb,
                                               torch.from_numpy(off)))
    want = gmm(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
               jnp.asarray(wb.float().numpy(), jnp.bfloat16),
               jnp.asarray(np.asarray(sizes, np.int32)),
               preferred_element_type=jnp.float32, tiling=(32, K, N),
               interpret=True).astype(jnp.bfloat16)
    # Both sum in fp32 and round once; the order of the sums may move a
    # value by one bf16 step (2^-7 at |y| < 2).
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=2 ** -7)


@pytest.mark.parametrize("shape", ["K", "N", "dtype", "offsets"])
def test_wrapper_raises_on_what_the_kernel_cannot_take(shape):
    """Checked before any launch: on a device other than the CPU the
    wrapper raises instead of falling back to the plain version."""
    K, N = (12 if shape == "K" else 16), (20 if shape == "N" else 24)
    x = torch.empty((32, K), dtype=torch.bfloat16, device="meta")
    w = torch.empty((3, K, N), device="meta", dtype=(
        torch.float32 if shape == "dtype" else torch.bfloat16))
    off = torch.empty((3 if shape == "offsets" else 4,), device="meta",
                      dtype=torch.int32)
    with pytest.raises(ValueError):
        grouped_matmul(x, w, off)
