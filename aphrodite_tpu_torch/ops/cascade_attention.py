"""Cascade (shared-prefix) attention for the decode window.

When every request of a decode window holds the same leading KV pages
(prefix caching dedups them physically), the shared prefix is attended
once for the whole batch each sub-step, one pass of all R * group query
rows of each KV head over the shared tokens, and the window decode kernel
starts each request from that pass's unnormalized online-softmax state
(``window_decode_attention(..., cascade_init=...)``), reading only the keys
past the prefix. Causality is free: every query sits past the prefix.

``shared_prefix_attention`` launches the hand-written CUDA kernel
(``csrc/shared_prefix_attention.cu``, which replaces the TPU kernel
``aphrodite_tpu/ops/cascade_attention.py:shared_prefix_attention`` /
``_spa_kernel``) on CUDA tensors, and runs the plain PyTorch version
``ref_shared_prefix_attention`` on CPU tensors. The state it returns is
fp32 ``acc [R, kvh, group, hd]`` and ``m, l [R, kvh, group]`` (the TPU
kernel's 128-lane widening of m and l is not copied). A row with no shared
token gets m = -inf, l = 0 and acc = 0.

In bf16 and fp16 at head_dim 64, 128 or 256 the kernel runs 64 query
rows of one KV head a block on the tensor cores (fp16's products on fp16
operands; at MLA's 576 the CUDA-core instance),
and splits the shared keys across blocks too
(``shared_split_plan``); the last block of a row tile to finish merges the
splits in a fixed order. ``shared_prefix_plan`` makes the plan, its
scratch and its counters once for all the layers and sub-steps of a decode
window.

The cache holds q's dtype or fp8 (e4m3fn or e5m2): both instances upcast
an fp8 K/V tile to q's dtype before both products, as the TPU kernel does
(the tensor-core instance stages its bytes in a ring of their own:
``spa_tc_smem_bytes(hd, fp8=True)``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops.ragged_paged_attention import (DTYPE_CODES,
                                                           KV_CODES, kv_code)
from aphrodite_tpu_torch.ops.window_decode_attention import (
    ref_window_decode_attention)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
             _I, _I, _F, _I, _I, _I, _P]
_TILE = 32         # keys staged at a time (CUDA-core instance)
_ROWS = 32         # query rows a block (8 warps of 4)
TC_ROWS = 64       # query rows a block of the tensor-core instance
MAX_SPLITS = 32    # splits the kernel's merge takes
TC_HEAD_DIMS = (64, 128, 256)  # the tensor-core instance's head dims
# The head dims the kernel takes: the tensor-core ones and MLA's latent
# head (576), which runs the CUDA-core instance in bf16 too.
HEAD_DIMS = TC_HEAD_DIMS + (576,)


def spa_smem_bytes(hd: int) -> int:
    """Shared memory of one launch (the kernel's layout, all fp32): the
    block's q rows [32, hd], K transposed [hd, 33], V [32, hd + 1], and p
    [8 warps, 4 rows, 32]."""
    return 4 * (_ROWS * hd + hd * (_TILE + 1) + _TILE * (hd + 1)
                + _ROWS * _TILE)


def spa_tile_keys(hd: int) -> int:
    """Keys a tile of the tensor-core instance: 64, 32 at head_dim 256."""
    return 64 if hd <= 128 else 32


def spa_tc_smem_bytes(hd: int, fp8: bool = False) -> int:
    """Shared memory of the tensor-core instance: 64 query rows and a ring
    of K and V tiles (3 stages at head_dim 64, else 2), bf16 rows padded
    by 8; an fp8 cache adds a ring of the same stages of staged bytes."""
    stages = 3 if hd <= 64 else 2
    keys = spa_tile_keys(hd)
    return (2 * (hd + 8) * (TC_ROWS + stages * 2 * keys)
            + (stages * 2 * keys * hd if fp8 else 0))


def shared_split_plan(blocks: int, tiles: int,
                      num_sms: int) -> tuple[int, int]:
    """(splits, tiles a split) for ``blocks`` (row tile, KV head) pairs
    over ``tiles`` key tiles: whole tiles a split, as many splits as give
    the card about two blocks an SM, but at least two tiles a split where
    there are two, and at most ``MAX_SPLITS`` splits. No tile: one
    split."""
    if tiles <= 0:
        return 1, 1
    want = max(1, -(-2 * num_sms // blocks))
    per = max(min(2, tiles), -(-tiles // want), -(-tiles // MAX_SPLITS))
    return -(-tiles // per), per


class SharedPlan(NamedTuple):
    """One shared-prefix launch's geometry and split plan
    (``shared_prefix_plan``)."""
    key: tuple          # (dtype, R, nq, kvh, hd, shared_len)
    tensor_cores: bool
    smem: int
    splits: int
    tiles_per_split: int
    part: Optional[torch.Tensor]      # fp32 scratch of the splits' states
    counters: Optional[torch.Tensor]  # int32, one a (row tile, KV head)
    kv_dtype: Optional[torch.dtype] = None  # the cache's (None: dtype)


def shared_prefix_plan(dtype: torch.dtype, num_reqs: int, nq: int, kvh: int,
                       hd: int, shared_len: int, device,
                       kv_dtype: Optional[torch.dtype] = None) -> SharedPlan:
    """The launch geometry for queries of ``dtype`` on a cache of
    ``kv_dtype`` (None: ``dtype``), the key-split plan and, with more than one
    split, the scratch of the splits' states (acc [splits, kvh, R * group,
    hd], then m and l [splits, kvh, R * group]) and the zeroed counters
    of the kernel's merge (the kernel leaves them zero). bf16 and fp16 run
    the tensor-core instance (at head_dim 64, 128 or 256; at MLA's 576 the
    CUDA-core one); fp32 the CUDA-core one, which takes no split."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    smem_limit = (cuda_build.smem_optin() if cuda
                  else cuda_build.H100_SMEM_OPTIN)
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    key = (dtype, num_reqs, nq, kvh, hd, shared_len)
    if dtype not in (torch.bfloat16, torch.float16) \
            or hd not in TC_HEAD_DIMS:
        smem = spa_smem_bytes(hd)
        cuda_build.check_smem("shared_prefix_attention", smem, smem_limit)
        return SharedPlan(key, False, smem, 1, 1, None, None, kv_dtype)
    smem = spa_tc_smem_bytes(hd, kv_dtype in KV_CODES)
    cuda_build.check_smem("shared_prefix_attention", smem, smem_limit)
    rows = num_reqs * (nq // kvh)
    row_tiles = -(-rows // TC_ROWS)
    splits, per = shared_split_plan(
        row_tiles * kvh, -(-shared_len // spa_tile_keys(hd)),
        cuda_build.sm_count(device) if cuda else cuda_build.H100_SMS)
    part = counters = None
    if splits > 1:
        part = torch.empty(splits * kvh * rows * (hd + 2),
                           dtype=torch.float32, device=device)
        counters = torch.zeros(row_tiles * kvh, dtype=torch.int32,
                               device=device)
    return SharedPlan(key, True, smem, splits, per, part, counters,
                      kv_dtype)


def ref_shared_prefix_attention(
    q: torch.Tensor,             # [R, nq, hd]
    cache_layer: torch.Tensor,   # [P, 2, kvh, page, hd]
    shared_pages: torch.Tensor,  # [n] int32 physical page ids
    shared_len: int,             # tokens of the prefix, <= n * page
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, in fp32 (an fp8 cache upcast exactly): (acc
    unnormalized, m, l)."""
    _, _, kvh, page, hd = cache_layer.shape
    R, nq, _ = q.shape
    group = nq // kvh
    kv = cache_layer[shared_pages.long()]            # [n, 2, kvh, page, hd]
    kv = kv.permute(1, 2, 0, 3, 4).reshape(2, kvh, -1, hd).float()
    keys, values = kv[0], kv[1]                      # [kvh, n * page, hd]
    qf = q.float().reshape(R, kvh, group, hd)
    s = torch.einsum("rhgd,hkd->rhgk", qf, keys) * scale
    valid = torch.arange(keys.shape[1], device=q.device) < shared_len
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])             # masked keys: 0
    return (torch.einsum("rhgk,hkd->rhgd", p, values), m, p.sum(dim=-1))


def ref_cascade_window_decode(
    q: torch.Tensor, cache_layer: torch.Tensor, tail_k_l: torch.Tensor,
    tail_v_l: torch.Tensor, step: int, paged_lens: torch.Tensor,
    block_tables: torch.Tensor, shared_pages: torch.Tensor, shared_len: int,
    scale: float) -> torch.Tensor:
    """The cascade split in plain PyTorch (the JAX package's oracle of the
    same name): the shared-prefix state, then the window attention over
    the keys past the prefix started from it. Equals the plain window
    attention over the whole context."""
    init = ref_shared_prefix_attention(q, cache_layer, shared_pages,
                                       shared_len, scale)
    return ref_window_decode_attention(
        q, cache_layer, tail_k_l, tail_v_l, step, paged_lens, block_tables,
        scale, cascade_init=init, shared_len=shared_len)


def shared_prefix_attention(
    q: torch.Tensor,             # [R, nq, hd]
    kv_cache: torch.Tensor,      # [L, P, 2, kvh, page, hd] (frozen)
    layer: int,
    shared_pages: torch.Tensor,  # [n] int32
    shared_len: int,
    scale: float,
    plan: Optional[SharedPlan] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The shared prefix's online-softmax state for every request's query:
    (acc [R, kvh, group, hd], m [R, kvh, group], l [R, kvh, group]), fp32,
    reading the shared pages once. The kernel reads the layer's cache
    through its base pointer: nothing is copied. ``plan``: the CUDA
    launch's ``shared_prefix_plan`` (the runner makes one a decode
    window); by default one made here."""
    R, nq, hd = q.shape
    _, _, _, kvh, page, hd_c = kv_cache.shape
    if hd_c != hd or nq % kvh:
        raise ValueError(f"bad geometry: q {tuple(q.shape)} cache "
                         f"{tuple(kv_cache.shape)}")
    if not 0 <= shared_len <= shared_pages.numel() * page:
        raise ValueError(f"shared_len {shared_len} outside the "
                         f"{shared_pages.numel()} shared pages of {page}")
    code = kv_code(q.dtype, kv_cache.dtype)
    if q.device.type == "cpu":
        return ref_shared_prefix_attention(q, kv_cache[layer], shared_pages,
                                           shared_len, scale)
    if not q.is_cuda or q.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported query tensor: {q.device} {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the kernel takes {HEAD_DIMS}")
    if not (q.is_contiguous() and kv_cache.is_contiguous()):
        raise ValueError("q and cache must be contiguous")
    if shared_pages.dtype != torch.int32 or not shared_pages.is_contiguous() \
            or shared_pages.device != q.device:
        raise ValueError("shared_pages must be contiguous int32 on q's "
                         "device")
    group = nq // kvh
    if plan is None:
        plan = shared_prefix_plan(q.dtype, R, nq, kvh, hd, shared_len,
                                  q.device, kv_cache.dtype)
    elif plan.key != (q.dtype, R, nq, kvh, hd, shared_len) \
            or (plan.kv_dtype or q.dtype) != kv_cache.dtype or (
            plan.part is not None and plan.part.device != q.device):
        raise ValueError(f"the shared-prefix plan {plan.key} does not fit "
                         f"q {q.dtype} {tuple(q.shape)}, kvh {kvh}, "
                         f"shared_len {shared_len} on {q.device}")
    if plan.tensor_cores and (q.data_ptr() % 16 or kv_cache.data_ptr() % 16):
        raise ValueError("q and the cache must be 16-byte aligned")
    acc = torch.empty((R, kvh, group, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.empty((R, kvh, group), dtype=torch.float32, device=q.device)
    lsum = torch.empty_like(m)
    launch = cuda_build.entry("shared_prefix_attention", "spa_launch",
                              _ARGTYPES)
    err = launch(
        DTYPE_CODES[q.dtype], code, int(plan.tensor_cores), q.data_ptr(),
        kv_cache[layer].data_ptr(), shared_pages.data_ptr(), shared_len,
        acc.data_ptr(), m.data_ptr(), lsum.data_ptr(),
        plan.part.data_ptr() if plan.part is not None else None,
        plan.counters.data_ptr() if plan.counters is not None else None,
        R, nq, kvh, page, hd, scale, plan.smem, plan.splits,
        plan.tiles_per_split, cuda_build.stream(q.device))
    cuda_build.check(err, "shared_prefix_attention launch")
    shared_prefix_attention.launches += 1
    return acc, m, lsum


# Launches of the CUDA kernel (a run sets it to 0 and reads it after).
shared_prefix_attention.launches = 0
