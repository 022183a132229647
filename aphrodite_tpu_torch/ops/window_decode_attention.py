"""Window decode attention: one query per request over a frozen paged
cache plus the window's tail.

``window_decode_attention`` launches the hand-written CUDA kernel
(``csrc/window_decode_attention.cu``, which replaces the TPU kernel
``aphrodite_tpu/ops/window_decode_attention.py:_wd_kernel``) on CUDA
tensors, and runs the plain PyTorch version ``ref_window_decode_attention``
on CPU tensors. Request r's query sits at position paged_lens[r] + step; it
attends to page positions < paged_lens[r] and to tail slots j <= step.

With ``cascade_init=(acc0, m0, l0)`` and ``shared_len=S`` (the TPU kernel's
cascade option) the page positions < S are already covered by that
unnormalized online-softmax state (``ops/cascade_attention.py``): the
kernel reads only page positions >= S and merges the state in once.

The kernel splits each request's visible keys into tiles of 64 and the
tiles into ``splits`` ranges, one block each (``window_split_plan``, the
last split taking whatever is left); each block writes an unnormalized
(acc, m, l) state and a second kernel merges them in a fixed order.
``window_plan`` makes the launch geometry, the plan and the states'
scratch once for all the layers and sub-steps of a decode window.

bf16 and fp16 at MLA's head_dim 576 (DeepSeek V2/V3: any group on one
latent KV head) run the MLA instance (``csrc/mla_attention.cuh``: bf16
``mla_window_launch`` of ``csrc/mla_attention.cu``, fp16
``mla_window_f16_launch`` of ``csrc/mla_attention_f16.cu``: wgmma over
one 64-row tile of the group a block,
each of the plan's 64-key tiles loaded by TMA as two of 32), one block an
SM, its splits planned for one wave (``window_split_plan(...,
per_sm=1)``). A group larger than a block's rows is cut into row slices,
one block each (grid.y), in every instance.

The cache holds q's dtype or fp8 (e4m3fn or e5m2); the tails hold the
cache's dtype, or bf16 beside an e5m2 cache (``tail_dtype``, the JAX
runner's rule). Every tile is upcast to q's dtype before both products,
as the TPU kernel does (the tensor-core instance stages fp8 tiles' bytes
in a ring of their own: ``window_tc_smem_bytes(hd, fp8=True)``; the MLA
instance stages them in its ring and converts them into two tiles of q's
dtype, ``mla_smem_bytes(fp8=True)``, and copies bf16 tails beside e5m2
straight into those tiles).

fp16 queries run the tensor-core instance, or at head_dim 576 the MLA
one, with fp16 operands and P rounded to fp16 (beside an e5m2 cache the
tails stay bf16, as the JAX runner keeps them, and the kernel converts
each tail tile to fp16 in shared memory, exact inside fp16's range).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops.ragged_paged_attention import (
    DTYPE_CODES, KV_CODES, MLA_HEAD_DIM, MLA_ROWS, TC_HEAD_DIMS, kv_code,
    mla_page_boxes, mla_smem_bytes)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
             _I, _I, _I, _I, _I, _I, _F, _I, _I, _F, _P, _P, _P, _I, _I, _I,
             _I, _I, _I, _P]
_MLA_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                 _I, _I, _I, _I, _I, _F, _I, _I, _F, _P, _P, _P, _I, _I, _I,
                 _P]
_TILE = 32  # keys per warp sub-tile of the CUDA-core instance
SPLIT_KEYS = 64  # keys a tile of the split plan
TC_MAX_GROUP = 16  # query rows of one mma tile
MLA_WARPS = 16  # a producer warpgroup and three consumer warpgroups


def tail_dtype(kv_dtype: torch.dtype) -> torch.dtype:
    """The window tails' dtype beside a cache of ``kv_dtype``: bf16 beside
    e5m2, else the cache's (``aphrodite_tpu/worker/runner.py:519-520``,
    where an e4m3fn cache is not in the tuple that picks bf16)."""
    return torch.bfloat16 if kv_dtype == torch.float8_e5m2 else kv_dtype


def window_smem_bytes(group: int, hd: int, warps: int) -> int:
    """Shared memory of a CUDA-core split block (``wd_split_kernel``'s
    layout): q [group, hd], then per warp a K sub-tile [32, hd + 1], a V
    sub-tile [32, hd], p [32], acc [group, hd], m and l [group], all
    fp32."""
    per_warp = _TILE * (2 * hd + 2) + group * hd + 2 * group
    return 4 * (group * hd + warps * per_warp)


def window_block_rows(group: int, hd: int, smem_limit: int) -> int:
    """Query rows a CUDA-core split block holds: the whole group where it
    fits with one warp, else as many as fit (at least one; 18 at MLA's
    head_dim 576): the kernel then cuts the group into slices."""
    if window_smem_bytes(group, hd, 1) <= smem_limit:
        return group
    per_row = 4 * (2 * hd + 2)  # q, acc, m and l of a row, one warp
    fixed = window_smem_bytes(0, hd, 1)
    return max(1, min(group, (smem_limit - fixed) // per_row))


def window_warps(group: int, hd: int, smem_limit: int) -> int:
    """Warps of a CUDA-core split block of ``window_block_rows`` rows: 4,
    else 2, else 1, the first whose sub-tiles fit the card's shared memory
    (2 at head_dim 256); raises when none fits."""
    rows = window_block_rows(group, hd, smem_limit)
    return cuda_build.fit_warps(
        f"window_decode_attention (group {group}, head_dim {hd}, {rows} "
        "rows a block)",
        lambda warps: window_smem_bytes(rows, hd, warps), smem_limit)


def window_uses_mla(dtype: torch.dtype, hd: int) -> bool:
    """Whether the kernel runs its MLA instance (bf16 or fp16, head_dim
    576)."""
    return dtype in (torch.bfloat16, torch.float16) and hd == MLA_HEAD_DIM


def window_uses_tensor_cores(dtype: torch.dtype, group: int,
                             hd: int) -> bool:
    """Whether the kernel runs its tensor-core instance of
    ``csrc/split_decode.cuh``: bf16 or fp16, head_dim 64, 128 or 256, and a
    group that fits one 16-row mma tile (MLA's head_dim 576 runs its own
    instance in bf16 and fp16: ``window_uses_mla``)."""
    return (dtype in (torch.bfloat16, torch.float16) and hd in TC_HEAD_DIMS
            and group <= TC_MAX_GROUP)


def window_tc_smem_bytes(hd: int, fp8: bool = False) -> int:
    """Shared memory of the tensor-core instance: 16 query rows and a ring
    of 2 stages of K and V tiles of 64 keys, bf16 rows padded by 8; an fp8
    cache adds a ring of 2 stages of staged bytes."""
    return (2 * (hd + 8) * (16 + 2 * 2 * SPLIT_KEYS)
            + (2 * 2 * SPLIT_KEYS * hd if fp8 else 0))


def _window_geometry(dtype: torch.dtype, group: int, hd: int,
                     smem_limit: int, fp8: bool = False
                     ) -> tuple[bool, int, int, int]:
    """``window_launch_geometry`` and the query rows a block holds."""
    what = f"window_decode_attention (group {group}, head_dim {hd})"
    if window_uses_mla(dtype, hd):
        smem = mla_smem_bytes(fp8)
        cuda_build.check_smem(what + " MLA instance", smem, smem_limit)
        return True, MLA_WARPS, smem, MLA_ROWS
    if window_uses_tensor_cores(dtype, group, hd):
        smem = window_tc_smem_bytes(hd, fp8)
        cuda_build.check_smem(what, smem, smem_limit)
        return True, 4, smem, group
    rows = window_block_rows(group, hd, smem_limit)
    warps = window_warps(group, hd, smem_limit)
    return False, warps, window_smem_bytes(rows, hd, warps), rows


def window_launch_geometry(dtype: torch.dtype, group: int, hd: int,
                           smem_limit: int, fp8: bool = False
                           ) -> tuple[bool, int, int]:
    """(tensor cores, warps, shared-memory bytes) of one split block: 4
    warps and ``window_tc_smem_bytes`` (16 warps and ``mla_smem_bytes``
    at MLA's geometry, on a cache of q's dtype or fp8) on a tensor-core
    instance, else the CUDA-core instance's ``window_warps`` (whose tiles
    are fp32 on any cache) for ``window_block_rows`` rows. Raises, naming
    the bytes, when nothing fits the card."""
    return _window_geometry(dtype, group, hd, smem_limit, fp8)[:3]


def window_max_tiles(max_paged_len: int, step: int, shared_len: int = 0,
                     sliding_window: Optional[int] = None,
                     chunk_attn: Optional[int] = None) -> int:
    """An upper bound on any request's 64-key tiles: its page tiles from
    the one holding its first visible position (at least ``shared_len``)
    to ``max_paged_len``, then its tail tiles. Mirrors the kernel's
    ``request_tiles``; a chunk bounds the range before a sliding window,
    as in ``first_visible``."""
    n_page = -(-max_paged_len // SPLIT_KEYS)
    if shared_len:  # a request shorter than S keeps at most one tile
        n_page = max(n_page - shared_len // SPLIT_KEYS, 1)
    if chunk_attn:
        n_page = min(n_page, chunk_attn // SPLIT_KEYS + 2)
    elif sliding_window:
        n_page = min(n_page, sliding_window // SPLIT_KEYS + 2)
    return n_page + -(-(step + 1) // SPLIT_KEYS)


def window_split_plan(blocks: int, max_tiles: int, num_sms: int,
                      per_sm: int = 4) -> tuple[int, int]:
    """(splits, tiles a split) for ``blocks`` (request, KV head) pairs
    whose visible keys span at most ``max_tiles`` tiles, for an instance
    of which ``per_sm`` blocks fit an SM. Four (the tensor-core and
    CUDA-core instances): whole tiles a split, as many as still give the
    card four blocks an SM, but at least two (so that a block's next load
    overlaps its products) where there are two. One (the MLA instance,
    whose K and V loads overlap within a tile): as many splits as fill at
    most one wave of the card (``num_sms`` blocks) where the pairs fit
    one, one split where they do not, the tiles spread evenly over them."""
    if per_sm == 1:
        want = max(1, num_sms // blocks)
        per = -(-max_tiles // min(want, max(max_tiles, 1)))
        return -(-max_tiles // per), per
    want = max(1, -(-per_sm * num_sms // blocks))
    per = max(min(2, max_tiles), max_tiles // want)
    return -(-max_tiles // per), per


def ref_window_decode_attention(
    q: torch.Tensor,            # [R, nq, hd]
    cache_layer: torch.Tensor,  # [P, 2, kvh, page, hd]
    tail_k_l: torch.Tensor,     # [R, kvh, Kw, hd] (layer slice)
    tail_v_l: torch.Tensor,
    step: int,
    paged_lens: torch.Tensor,   # [R]
    block_tables: torch.Tensor,  # [R, max_pages]
    scale: float,
    sliding_window: Optional[int] = None,
    chunk_attn: Optional[int] = None,
    logits_soft_cap: Optional[float] = None,
    cascade_init=None,
    shared_len: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version, in fp32 (CPU path and the kernel's yardstick
    of correctness; pages and tails upcast from their own dtypes, exactly).
    With ``cascade_init`` the page positions < ``shared_len`` are masked and
    the init state is merged with the suffix's (the JAX package's
    ``ref_cascade_window_decode``)."""
    _, _, kvh, page, hd = cache_layer.shape
    R, nq, _ = q.shape
    group = nq // kvh
    max_kv = block_tables.shape[1] * page
    Kw = tail_k_l.shape[2]
    kv = cache_layer[block_tables.long()]     # [R, MP, 2, kvh, page, hd]
    kv = kv.permute(0, 2, 3, 1, 4, 5).reshape(R, 2, kvh, max_kv, hd).float()
    keys = torch.cat([kv[:, 0], tail_k_l.float()], dim=2)   # [R,kvh,K+,hd]
    values = torch.cat([kv[:, 1], tail_v_l.float()], dim=2)
    qf = q.float().reshape(R, kvh, group, hd)
    logits = torch.einsum("rhgd,rhkd->rhgk", qf, keys) * scale
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    plen = paged_lens.long()[:, None]
    pos = plen + step
    j = torch.arange(Kw, device=q.device)[None, :]
    kv_pos = torch.cat([
        torch.arange(max_kv, device=q.device)[None, :].expand(R, max_kv),
        plen + j], dim=1)
    mask = torch.cat([kv_pos[:, :max_kv] < plen,
                      (j <= step).expand(R, Kw)], dim=1)
    if sliding_window is not None:
        mask &= kv_pos > pos - sliding_window
    if chunk_attn is not None:
        mask &= (kv_pos // chunk_attn) == (pos // chunk_attn)
    if cascade_init is not None:
        mask[:, :max_kv] &= kv_pos[:, :max_kv] >= shared_len
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    if cascade_init is None:
        probs = torch.softmax(logits, dim=-1).nan_to_num(0.0)
        out = torch.einsum("rhgk,rhkd->rhgd", probs, values)
        return out.reshape(R, nq, hd).to(q.dtype)
    # Online-softmax merge of the init state with the suffix's.
    acc0, m0, l0 = cascade_init
    m = torch.maximum(m0, logits.amax(dim=-1))
    m_fin = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    a0 = torch.where(torch.isfinite(m0), torch.exp(m0 - m_fin),
                     torch.zeros_like(m0))
    p = torch.exp(logits - m_fin[..., None])        # masked keys: 0
    lsum = l0 * a0 + p.sum(dim=-1)
    acc = acc0 * a0[..., None] + torch.einsum("rhgk,rhkd->rhgd", p, values)
    out = acc / lsum.clamp(min=1e-20)[..., None]
    return out.reshape(R, nq, hd).to(q.dtype)


class WindowPlan(NamedTuple):
    """One window launch's geometry and split plan (``window_plan``)."""
    key: tuple          # (dtype, R, nq, kvh, hd) of the launches it fits
    tensor_cores: bool
    warps: int
    smem: int
    splits: int
    tiles_per_split: int
    part: torch.Tensor  # fp32 scratch of the splits' (acc, m, l)
    kv_dtype: Optional[torch.dtype] = None  # the cache's (None: dtype)
    rows: int = 0       # query rows a block (0: the whole group)


def window_plan(dtype: torch.dtype, num_reqs: int, nq: int, kvh: int,
                hd: int, device, max_paged_len: int, step: int,
                shared_len: int = 0, sliding_window: Optional[int] = None,
                chunk_attn: Optional[int] = None,
                kv_dtype: Optional[torch.dtype] = None) -> WindowPlan:
    """The launch geometry (``window_launch_geometry``) for queries of
    ``dtype`` on a cache of ``kv_dtype`` (None: ``dtype``), the split plan
    for a bound on the paged lengths and the window step (a larger step
    bounds every smaller one), and the scratch of the splits' states: acc
    [R, nq, splits, hd], then m and l [R, nq, splits]. A bound below the
    real lengths costs speed only: the last split takes the rest."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    group = nq // kvh
    tc, warps, smem, rows = _window_geometry(
        dtype, group, hd,
        cuda_build.smem_optin() if cuda else cuda_build.H100_SMEM_OPTIN,
        kv_dtype in KV_CODES)
    splits, per = window_split_plan(
        num_reqs * kvh * -(-group // rows),
        window_max_tiles(max_paged_len, step, shared_len, sliding_window,
                         chunk_attn),
        cuda_build.sm_count(device) if cuda else cuda_build.H100_SMS,
        1 if window_uses_mla(dtype, hd) else 4)
    part = torch.empty(num_reqs * nq * splits * (hd + 2),
                       dtype=torch.float32, device=device)
    return WindowPlan((dtype, num_reqs, nq, kvh, hd), tc, warps, smem,
                      splits, per, part, kv_dtype, rows)


def window_decode_attention(
    q: torch.Tensor,          # [R, nq, hd]
    kv_cache: torch.Tensor,   # [L, P, 2, kvh, page, hd] (frozen)
    tail_k: torch.Tensor,     # [L, R, kvh, Kw, hd]
    tail_v: torch.Tensor,
    layer: int,
    step: int,
    paged_lens: torch.Tensor,   # [R] int32
    block_tables: torch.Tensor,  # [R, max_pages] int32
    scale: float,
    sliding_window: Optional[int] = None,
    chunk_attn: Optional[int] = None,
    logits_soft_cap: Optional[float] = None,
    cascade_init=None,
    shared_len: int = 0,
    plan: Optional[WindowPlan] = None,
) -> torch.Tensor:
    """Attention output [R, nq, hd] in q's dtype. The kernel reads the
    layer's cache and tails through base pointers: nothing is copied.
    ``cascade_init``: (acc0 [R, kvh, group, hd], m0 [R, kvh, group], l0
    [R, kvh, group]) fp32 covering page positions < ``shared_len``; it
    takes no sliding window, chunk or soft cap (the shared pass has none).
    ``plan``: the CUDA launch's ``window_plan`` (the runner makes one for
    every layer of a window); by default one bounded by the block tables'
    capacity."""
    if cascade_init is not None and (sliding_window or chunk_attn
                                     or logits_soft_cap):
        raise ValueError("the cascade init state takes no sliding window, "
                         "chunked attention or soft cap")
    code = kv_code(q.dtype, kv_cache.dtype)
    want = tail_dtype(kv_cache.dtype)
    if tail_k.dtype != want or tail_v.dtype != want:
        raise ValueError(f"tails of {tail_k.dtype} / {tail_v.dtype} beside "
                         f"a {kv_cache.dtype} cache: want {want}")
    if q.device.type == "cpu":
        return ref_window_decode_attention(
            q, kv_cache[layer], tail_k[layer], tail_v[layer], step,
            paged_lens, block_tables, scale, sliding_window=sliding_window,
            chunk_attn=chunk_attn, logits_soft_cap=logits_soft_cap,
            cascade_init=cascade_init, shared_len=shared_len)
    dev = q.device
    if not q.is_cuda or q.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported query tensor: {dev} {q.dtype}")
    for t in (q, kv_cache, tail_k, tail_v):
        if not t.is_contiguous():
            raise ValueError("q, cache and tails must be contiguous")
    R, nq, hd = q.shape
    _, _, _, kvh, page, hd_c = kv_cache.shape
    Kw = tail_k.shape[3]
    if hd_c != hd or nq % kvh or tail_k.shape[1:] != (R, kvh, Kw, hd):
        raise ValueError(f"bad geometry: q {tuple(q.shape)} cache "
                         f"{tuple(kv_cache.shape)} tail "
                         f"{tuple(tail_k.shape)}")
    if not 0 <= step < Kw:
        raise ValueError(f"step {step} outside the tail of {Kw} slots")
    for t in (paged_lens, block_tables):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError("metadata must be contiguous int32 on q's "
                             "device")
    group = nq // kvh
    init = (None, None, None)
    if cascade_init is not None:
        for t, shape in zip(cascade_init, ((R, kvh, group, hd),
                                           (R, kvh, group), (R, kvh, group))):
            if t.dtype != torch.float32 or t.shape != shape \
                    or not t.is_contiguous() or t.device != dev:
                raise ValueError(f"cascade_init: want contiguous fp32 "
                                 f"{shape} on {dev}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        init = tuple(t.data_ptr() for t in cascade_init)
    elif shared_len:
        raise ValueError("shared_len without a cascade init state")
    out = torch.empty_like(q)
    if R == 0:
        return out
    if plan is None:
        plan = window_plan(q.dtype, R, nq, kvh, hd, dev,
                           block_tables.shape[1] * page, step, shared_len,
                           sliding_window, chunk_attn, kv_cache.dtype)
    elif plan.key != (q.dtype, R, nq, kvh, hd) \
            or (plan.kv_dtype or q.dtype) != kv_cache.dtype \
            or plan.part.device != dev:
        raise ValueError(f"the window plan {plan.key} on {plan.part.device} "
                         f"does not fit q {q.dtype} {tuple(q.shape)}, a "
                         f"{kv_cache.dtype} cache, kvh {kvh} on {dev}")
    if plan.tensor_cores:
        for t in (q, kv_cache, tail_k, tail_v):
            if t.data_ptr() % 16:
                raise ValueError("q, cache and tails must be 16-byte "
                                 "aligned")
    n_state = R * nq * plan.splits
    part_m = plan.part.data_ptr() + 4 * n_state * hd
    # The layer's cache and tails by their offsets in the full tensors.
    cache_l = (kv_cache.data_ptr()
               + layer * kv_cache.stride(0) * kv_cache.element_size())
    tail_off = layer * tail_k.stride(0) * tail_k.element_size()
    if window_uses_mla(q.dtype, hd):
        mla_page_boxes(page)  # raises on a page size TMA cannot tile
        # The fp16 instances are a library of their own (built beside).
        launch = (cuda_build.entry("mla_attention_f16",
                                   "mla_window_f16_launch", _MLA_ARGTYPES)
                  if q.dtype == torch.float16 else
                  cuda_build.entry("mla_attention", "mla_window_launch",
                                   _MLA_ARGTYPES))
        err = launch(
            DTYPE_CODES[q.dtype], code, q.data_ptr(), cache_l,
            tail_k.data_ptr() + tail_off,
            tail_v.data_ptr() + tail_off, out.data_ptr(),
            plan.part.data_ptr(), part_m, part_m + 4 * n_state,
            paged_lens.data_ptr(), block_tables.data_ptr(), R,
            block_tables.shape[1], kv_cache.shape[1], nq, kvh, page, Kw,
            step, scale, sliding_window or 0, chunk_attn or 0,
            logits_soft_cap or 0.0,
            *init, shared_len, plan.splits, plan.tiles_per_split,
            cuda_build.stream(dev))
        instance = "mla"
    else:
        launch = cuda_build.entry("window_decode_attention", "wd_launch",
                                  _ARGTYPES)
        err = launch(
            DTYPE_CODES[q.dtype], code, int(plan.tensor_cores), q.data_ptr(),
            cache_l,
            tail_k.data_ptr() + tail_off, tail_v.data_ptr() + tail_off,
            out.data_ptr(), plan.part.data_ptr(), part_m,
            part_m + 4 * n_state, paged_lens.data_ptr(),
            block_tables.data_ptr(), R, block_tables.shape[1], nq, kvh, page,
            hd, Kw, step, scale, sliding_window or 0, chunk_attn or 0,
            logits_soft_cap or 0.0, *init, shared_len, plan.splits,
            plan.tiles_per_split, plan.warps, plan.smem,
            plan.rows or group, cuda_build.stream(dev))
        instance = "tensor_cores" if plan.tensor_cores else "scalar"
    cuda_build.check(err, "window_decode_attention launch")
    window_decode_attention.launches += 1
    window_decode_attention.instance_launches[instance] += 1
    window_decode_attention.dtype_launches[str(q.dtype).removeprefix(
        "torch.")] += 1
    return out


# Launches of the CUDA kernel (a run sets it to 0 and reads it after), in
# all, by instance and by q's dtype.
window_decode_attention.launches = 0
window_decode_attention.instance_launches = {"tensor_cores": 0, "mla": 0,
                                             "scalar": 0}
window_decode_attention.dtype_launches = {"float32": 0, "bfloat16": 0,
                                          "float16": 0}
