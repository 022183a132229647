"""Decode paged attention: one query token per request over the paged cache.

``decode_paged_attention`` launches the hand-written CUDA kernel
(``csrc/decode_paged_attention.cu``, which replaces the TPU kernel
``aphrodite_tpu/ops/decode_paged_attention.py:_decode_kernel``) on CUDA
tensors, and runs the plain PyTorch version ``ref_decode_paged_attention``
on CPU tensors. Request r's query sits at position seq_lens[r] - 1, whose
K/V the step has already written; it attends the request's positions
0..seq_lens[r] - 1. The runner's non-window multi-step decode
(``worker/runner.py: _execute_multi_step``) is its caller.

In bf16 and fp16 at any head_dim that is a multiple of 16 up to 256, and
any group (``decode_uses_tensor_cores``), the kernel runs on the tensor
cores: it splits each request's visible keys into tiles
(``decode_tile_keys``) and the tiles into ``splits`` ranges, and a KV
head's group of query rows into slices of 16 (one mma tile,
``decode_row_slices``), one block a (request, KV head, slice, split), the
last split taking whatever is left; each block writes an unnormalized
(acc, m, l) state of its rows and a second kernel merges each row's
splits in a fixed order (``decode_blocks`` models the grid for the CPU
tests). ``decode_plan`` makes the launch geometry, the split plan and the
states' scratch once for all the layers and sub-steps of a decode window.
fp32 (and bf16 or fp16 at a head_dim that is not a multiple of 16) runs
one block a (request, KV head) on the CUDA cores.
fp16 computes as the TPU kernel does in q's dtype: fp16 products (K/V
upcast from fp8 where the cache is), fp32 accumulation, P rounded to
fp16.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops.ragged_paged_attention import (
    DTYPE_CODES, KV_CODES, kv_code, tc_head_dim_ok, tc_width)
from aphrodite_tpu_torch.ops.window_decode_attention import (
    TC_MAX_GROUP, window_split_plan)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
             _I, _I, _I, _F, _I, _I, _F, _I, _I, _I, _I, _P]
_TILE = 32  # keys per warp tile of the CUDA-core instance


def decode_smem_bytes(group: int, hd: int, itemsize: int, warps: int) -> int:
    """Shared memory of one launch (the kernel's layout): q [group, hd]
    fp32, then per warp a K tile of 32 rows padded by one 32-bit word, a V
    tile (both in the cache's dtype), p [32], acc [group, hd], m and l
    [group] in fp32."""
    words = hd * itemsize // 4
    per_warp = _TILE * (2 * words + 1) + _TILE + group * hd + 2 * group
    return 4 * (group * hd + warps * per_warp)


def decode_warps(group: int, hd: int, itemsize: int, smem_limit: int) -> int:
    """Warps per block: 4, else 2, else 1, the first whose tiles fit the
    card's shared memory (fp32 at head_dim 256: 2); raises when none
    fits."""
    return cuda_build.fit_warps(
        f"decode_paged_attention (group {group}, head_dim {hd})",
        lambda warps: decode_smem_bytes(group, hd, itemsize, warps),
        smem_limit)


def decode_uses_tensor_cores(dtype: torch.dtype, group: int,
                             hd: int) -> bool:
    """Whether the kernel runs its tensor-core instance
    (``csrc/split_decode.cuh``): bf16 or fp16 at a head_dim that is a
    multiple of 16 up to 256 (``tc_head_dim_ok``), at any group (cut into
    ``decode_row_slices``). The window kernel keeps its own gate."""
    return dtype in (torch.bfloat16, torch.float16) and tc_head_dim_ok(hd)


def decode_row_slices(group: int) -> int:
    """Slices of 16 query rows (one mma tile) that a KV head's group is cut
    into, one block each: 1 up to 16, 5 at Falcon-7B's 71."""
    return -(-group // TC_MAX_GROUP)


def decode_tile_keys(hd: int) -> int:
    """Keys a tile of the tensor-core instance (the split plan's unit): 64,
    32 in 256-wide tiles (past head_dim 128: a smaller ring, so that three
    blocks share an SM)."""
    return 64 if tc_width(hd) <= 128 else 32


def decode_tc_smem_bytes(hd: int, fp8: bool = False) -> int:
    """Shared memory of the tensor-core instance (by the tiles' width w =
    ``tc_width(hd)``): 16 query rows and a ring of 2 stages of K and V
    tiles, 16-bit rows of w values padded by 8; an fp8 cache adds a ring
    of 2 stages of staged bytes."""
    w, keys = tc_width(hd), decode_tile_keys(hd)
    return (2 * (w + 8) * (16 + 2 * 2 * keys)
            + (2 * 2 * keys * w if fp8 else 0))


def decode_launch_geometry(dtype: torch.dtype, group: int, hd: int,
                           smem_limit: int,
                           kv_dtype: Optional[torch.dtype] = None
                           ) -> tuple[bool, int, int]:
    """(tensor cores, warps, shared-memory bytes) of one block for queries
    of ``dtype`` on a cache of ``kv_dtype`` (None: ``dtype``): 4 warps and
    ``decode_tc_smem_bytes`` on the tensor-core instance
    (``decode_uses_tensor_cores``), else the CUDA-core instance's
    ``decode_warps`` (its tiles in the cache's dtype). Raises, naming the
    bytes, when nothing fits the card."""
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    if decode_uses_tensor_cores(dtype, group, hd):
        smem = decode_tc_smem_bytes(hd, kv_dtype in KV_CODES)
        cuda_build.check_smem(
            f"decode_paged_attention (group {group}, head_dim {hd})", smem,
            smem_limit)
        return True, 4, smem
    itemsize = kv_dtype.itemsize
    warps = decode_warps(group, hd, itemsize, smem_limit)
    return False, warps, decode_smem_bytes(group, hd, itemsize, warps)


def decode_max_tiles(max_seq_len: int, keys: int,
                     sliding_window: Optional[int] = None,
                     chunk_attn: Optional[int] = None) -> int:
    """An upper bound on any request's tiles of ``keys`` keys when no
    request holds more than ``max_seq_len`` tokens: from the tile holding
    its first visible key to the one holding its query. A sliding window
    or a chunk bounds the visible range to that many keys (a range of n
    keys spans at most n // keys + 2 tiles). At least 1."""
    n = -(-max_seq_len // keys)
    for bound in (sliding_window, chunk_attn):
        if bound:
            n = min(n, bound // keys + 2)
    return max(n, 1)


class DecodePlan(NamedTuple):
    """One decode launch's geometry and split plan (``decode_plan``)."""
    key: tuple          # (dtype, R, nq, kvh, hd) of the launches it fits
    tensor_cores: bool
    warps: int
    smem: int
    splits: int
    tiles_per_split: int
    part: Optional[torch.Tensor]  # fp32 scratch of the splits' states
    kv_dtype: Optional[torch.dtype] = None  # the cache's (None: dtype)


def decode_plan(dtype: torch.dtype, num_reqs: int, nq: int, kvh: int,
                hd: int, device, max_seq_len: int,
                sliding_window: Optional[int] = None,
                chunk_attn: Optional[int] = None,
                kv_dtype: Optional[torch.dtype] = None) -> DecodePlan:
    """The launch geometry (``decode_launch_geometry``; ``kv_dtype`` the
    cache's, None for ``dtype``), the split plan
    for a bound on the requests' lengths (``window_split_plan`` over the
    (request, KV head, row slice) blocks: about four blocks an SM, at
    least two tiles a split) and the scratch of the splits' states: acc
    [R, nq, splits, hd], then m and l [R, nq, splits]. A bound below the
    real lengths costs speed only: the last split takes the rest. The
    CUDA-core instance takes no split."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    tc, warps, smem = decode_launch_geometry(
        dtype, nq // kvh, hd,
        cuda_build.smem_optin() if cuda else cuda_build.H100_SMEM_OPTIN,
        kv_dtype)
    key = (dtype, num_reqs, nq, kvh, hd)
    if not tc:
        return DecodePlan(key, False, warps, smem, 1, 1, None, kv_dtype)
    splits, per = window_split_plan(
        num_reqs * kvh * decode_row_slices(nq // kvh),
        decode_max_tiles(max_seq_len, decode_tile_keys(hd), sliding_window,
                         chunk_attn),
        cuda_build.sm_count(device) if cuda else cuda_build.H100_SMS)
    part = torch.empty(num_reqs * nq * splits * (hd + 2),
                       dtype=torch.float32, device=device)
    return DecodePlan(key, True, warps, smem, splits, per, part, kv_dtype)


class DecodeBlock(NamedTuple):
    """One block of the tensor-core instance's grid (``decode_blocks``)."""
    req: int
    kv_head: int
    row_slice: int
    split: int
    heads: range   # its query heads
    tiles: range   # its tiles of ``decode_tile_keys`` keys, absolute


def decode_blocks(plan: DecodePlan, seq_lens, sliding_window=None,
                  chunk_attn=None) -> list[DecodeBlock]:
    """The tensor-core instance's grid as ``dpa_split_tc_kernel`` walks it,
    for the CPU tests: block (request r, KV head h, row slice z, split s)
    takes query heads h * group + 16 z ... (at most 16) and, of the
    request's tiles from the one holding its first visible key (the
    window's and the chunk's bound) to the one holding its query, tiles
    [s * tiles_per_split, ...) of the split (``my_tiles``: fewer at the
    end, the last split taking the rest). The merge then adds each query
    row's splits in the order 0, 1, ... (``split::merge_row``)."""
    _, R, nq, kvh, hd = plan.key
    group, keys = nq // kvh, decode_tile_keys(hd)
    out = []
    for r in range(R):
        pos = int(seq_lens[r]) - 1
        lo = 0
        if sliding_window:
            lo = max(lo, pos - sliding_window + 1)
        if chunk_attn and pos >= 0:
            lo = max(lo, pos // chunk_attn * chunk_attn)
        t0 = lo // keys
        n = pos // keys + 1 - t0 if pos >= 0 else 0
        for h in range(kvh):
            for z in range(decode_row_slices(group)):
                g0 = h * group + TC_MAX_GROUP * z
                heads = range(g0, min(g0 + TC_MAX_GROUP, (h + 1) * group))
                for sp in range(plan.splits):
                    ta = sp * plan.tiles_per_split
                    end = (n if sp == plan.splits - 1
                           else min(ta + plan.tiles_per_split, n))
                    out.append(DecodeBlock(r, h, z, sp, heads, range(
                        t0 + ta, t0 + max(end, ta))))
    return out


def ref_decode_paged_attention(
    q: torch.Tensor,             # [R, nq, hd]
    cache_layer: torch.Tensor,   # [P, 2, kvh, page, hd]
    block_tables: torch.Tensor,  # [R, max_pages]
    seq_lens: torch.Tensor,      # [R]
    scale: float,
    sliding_window: Optional[int] = None,
    chunk_attn: Optional[int] = None,
    logits_soft_cap: Optional[float] = None,
    alibi: Optional[torch.Tensor] = None,  # [nq] fp32 slopes
) -> torch.Tensor:
    """Plain PyTorch version, in fp32 (CPU path and the kernel's yardstick
    of correctness): each request's pages gathered (an fp8 cache upcast
    exactly), one masked softmax per query row. ALiBi is added before the
    soft cap, as the TPU kernel adds it. Rows with seq_len 0, and fully
    masked rows, give 0."""
    _, _, kvh, page, hd = cache_layer.shape
    R, nq, _ = q.shape
    group = nq // kvh
    max_kv = block_tables.shape[1] * page
    kv = cache_layer[block_tables.long()]     # [R, MP, 2, kvh, page, hd]
    kv = kv.permute(0, 2, 3, 1, 4, 5).reshape(R, 2, kvh, max_kv, hd).float()
    qf = q.float().reshape(R, kvh, group, hd)
    logits = torch.einsum("rhgd,rhkd->rhgk", qf, kv[:, 0]) * scale
    pos = seq_lens.long()[:, None] - 1                       # [R, 1]
    kv_pos = torch.arange(max_kv, device=q.device)[None, :]  # [1, max_kv]
    if alibi is not None:
        slopes = alibi.float().reshape(kvh, group)
        logits = logits + (slopes[None, :, :, None]
                           * (kv_pos - pos).float()[:, None, None, :])
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    mask = kv_pos <= pos
    if sliding_window is not None:
        mask &= kv_pos > pos - sliding_window
    if chunk_attn is not None:
        mask &= (kv_pos // chunk_attn) == (pos // chunk_attn)
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1).nan_to_num(0.0)
    out = torch.einsum("rhgk,rhkd->rhgd", probs, kv[:, 1])
    return out.reshape(R, nq, hd).to(q.dtype)


def decode_paged_attention(
    q: torch.Tensor,             # [R, nq, hd]
    kv_cache: torch.Tensor,      # [L, P, 2, kvh, page, hd]
    layer: int,
    block_tables: torch.Tensor,  # [R, max_pages] int32
    seq_lens: torch.Tensor,      # [R] int32
    scale: float,
    sliding_window: Optional[int] = None,
    chunk_attn: Optional[int] = None,
    logits_soft_cap: Optional[float] = None,
    alibi: Optional[torch.Tensor] = None,
    plan: Optional[DecodePlan] = None,
) -> torch.Tensor:
    """Attention output [R, nq, hd] in q's dtype. ``alibi``: [nq] fp32
    slopes on q's device, or None. The kernel reads the layer through its
    base pointer in the full cache: nothing is copied. ``plan``: the CUDA
    launch's ``decode_plan`` (the runner makes one for every layer and
    sub-step of a decode window); by default one bounded by the block
    tables' capacity."""
    code = kv_code(q.dtype, kv_cache.dtype)
    cache_layer = kv_cache[layer]
    if q.device.type == "cpu":
        return ref_decode_paged_attention(
            q, cache_layer, block_tables, seq_lens, scale,
            sliding_window=sliding_window, chunk_attn=chunk_attn,
            logits_soft_cap=logits_soft_cap, alibi=alibi)
    if not q.is_cuda or q.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported query tensor: {q.device} {q.dtype}")
    if not (q.is_contiguous() and kv_cache.is_contiguous()):
        raise ValueError("q and the KV cache must be contiguous")
    R, nq, hd = q.shape
    _, _, kvh, page, hd_c = cache_layer.shape
    if hd_c != hd or nq % kvh or (hd * kv_cache.element_size()) % 4:
        raise ValueError(f"bad geometry: q {tuple(q.shape)} cache "
                         f"{tuple(cache_layer.shape)}")
    for t in (seq_lens, block_tables):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError("metadata must be contiguous int32 on q's "
                             "device")
    if alibi is not None and (alibi.dtype != torch.float32
                              or alibi.shape != (nq,)
                              or not alibi.is_contiguous()
                              or alibi.device != q.device):
        raise ValueError("alibi must be contiguous [nq] float32 on q's "
                         "device")
    out = torch.empty_like(q)
    if R == 0:
        return out
    if plan is None:
        plan = decode_plan(q.dtype, R, nq, kvh, hd, q.device,
                           block_tables.shape[1] * page, sliding_window,
                           chunk_attn, kv_cache.dtype)
    elif plan.key != (q.dtype, R, nq, kvh, hd) \
            or (plan.kv_dtype or q.dtype) != kv_cache.dtype or (
            plan.part is not None and plan.part.device != q.device):
        raise ValueError(f"the decode plan {plan.key} does not fit q "
                         f"{q.dtype} {tuple(q.shape)}, kvh {kvh} on "
                         f"{q.device}")
    part = part_m = part_l = None
    if plan.tensor_cores:
        if q.data_ptr() % 16 or kv_cache.data_ptr() % 16:
            raise ValueError("q and the KV cache must be 16-byte aligned")
        n_state = R * nq * plan.splits
        part = plan.part.data_ptr()
        part_m = part + 4 * n_state * hd
        part_l = part_m + 4 * n_state
    launch = cuda_build.entry("decode_paged_attention", "dpa_launch",
                              _ARGTYPES)
    err = launch(
        DTYPE_CODES[q.dtype], code, int(plan.tensor_cores), q.data_ptr(),
        cache_layer.data_ptr(), out.data_ptr(), part, part_m, part_l,
        seq_lens.data_ptr(), block_tables.data_ptr(),
        alibi.data_ptr() if alibi is not None else None, R,
        block_tables.shape[1], nq, kvh, page, hd, scale, sliding_window or 0,
        chunk_attn or 0, logits_soft_cap or 0.0, plan.splits,
        plan.tiles_per_split, plan.warps, plan.smem,
        cuda_build.stream(q.device))
    cuda_build.check(err, "decode_paged_attention launch")
    decode_paged_attention.launches += 1
    decode_paged_attention.instance_launches[
        "tensor_cores" if plan.tensor_cores else "scalar"] += 1
    return out


# Launches of the CUDA kernel (a run sets it to 0 and reads it after), in
# all and by instance: the tensor-core split ("tensor_cores") or the
# CUDA-core ``dpa_kernel`` ("scalar").
decode_paged_attention.launches = 0
decode_paged_attention.instance_launches = {"tensor_cores": 0, "scalar": 0}
