"""Ragged paged attention for prefill and mixed waves.

``ragged_paged_attention`` launches the hand-written CUDA kernel
(``csrc/ragged_paged_attention.cu``, which replaces the TPU kernel
``aphrodite_tpu/ops/ragged_paged_attention.py:_rpa_kernel``) on CUDA
tensors, and runs the plain PyTorch version ``ref_ragged_paged_attention``
on CPU tensors. ``ragged_route`` names the library and entry that take a
call: bf16 and fp16 at any head_dim that is a multiple of 16 up to 256
run the tensor-core instance (in tiles 64, 128 or 256 wide, the
narrowest that holds the head: ``tc_width``; bf16 ``rpa_tc_launch``,
fp16 ``rpa_tc_f16_launch`` of ``csrc/ragged_f16.cu``; with image spans
``rpa_tc_spans_launch`` of ``csrc/ragged_spans.cu`` and
``rpa_tc_spans_f16_launch`` of ``csrc/ragged_spans_f16.cu``, with or
without ALiBi), bf16 and fp16 at
MLA's head_dim 576 (DeepSeek V2/V3: any group on one latent KV head, on a
cache of q's dtype or fp8) the MLA instance (``csrc/mla_attention.cuh``:
bf16 ``mla_ragged_launch`` of ``csrc/mla_attention.cu``, fp16
``mla_ragged_f16_launch`` of ``csrc/mla_attention_f16.cu``; with image
spans or ALiBi its option instances, ``mla_ragged_opts_launch`` of
``csrc/mla_opts.cu`` and ``mla_ragged_opts_f16_launch`` of
``csrc/mla_opts_f16.cu``), everything else the scalar one
(``rpa_launch``): fp32, which it keeps in full fp32, and bf16 or fp16 at
a head_dim that is not a multiple of 16; each is sized by its own
function and the runner asks ``ragged_work_item_tokens`` for the one that
the model's dtype will run. No option of the TPU kernel is refused.
Where a work item's rows exceed an instance's block (a group of 128 query
heads), its rows are cut into slices, one block each. Query token i of
request r at position p attends to the request's KV positions j <= p,
read through its block table from one layer of the paged cache, optionally
restricted by a sliding window or chunked local attention, with an
optional logit soft cap and ALiBi: the bias slope[h] * (j - p) on the
scaled logit, before the soft cap, as the TPU kernel adds it
(``ragged_paged_attention.py:201-216``; the JAX oracle
``attention/backend.py`` adds it after the cap, so the two agree only
without one).

Bidirectional image spans (``md.mm_bidir_spans``: int32 [R, M, 2], (lo,
hi) per image of each request and -1 padding; Gemma-3 multimodal): a
query and a key that both lie in one span of the query's request see each
other in either order, below the request's seq_len, before the sliding
window and the chunk: the TPU kernel's mask
(``ragged_paged_attention.py:173-184``) and the JAX oracle's
(``attention/backend.py:179-191``). The tensor-core instance takes them
as a template switch (ALiBi, a switch elsewhere, is a uniform branch in
those instances), the scalar one as a uniform branch,
the MLA instance in its option instances (spans and slopes through
pointers, either null). Only Gemma-3 multimodal has spans; no model has
them at the MLA geometry or beside ALiBi, and ALiBi at the MLA geometry
neither: ``chip_smoke.py`` phase 2 holds those instances against the plain
version.

The cache holds q's dtype or fp8 (e4m3fn or e5m2): every instance upcasts
an fp8 K/V tile to q's dtype before both products, as the TPU kernel does
(the tensor-core instance through a ring of staged bytes, sized by
``ragged_tc_smem_bytes(hd, fp8=True)``; the MLA instance through a ring of
staged bytes and two tiles of q's dtype in its 16-bit ring's bytes,
``mla_smem_bytes(fp8=True)``); the plain version computes in fp32, where
every fp8 value is exact.

fp16 queries compute as the TPU kernel does in q's dtype: K/V in fp16
(or fp8 upcast to fp16), products accumulated in fp32, P rounded to fp16,
on the tensor-core and the MLA instances alike, with or without the
options.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.ops import cuda_build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
             _I, _I, _I, _I, _F, _I, _I, _F, _P, _P, _I, _I, _P]
_TC_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                _I, _I, _I, _F, _I, _I, _F, _P, _P, _I, _P]
_MLA_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                 _I, _I, _I, _F, _I, _I, _F, _P]
# The MLA option instances': the slopes, the spans and their count before
# the stream.
_MLA_OPTS_ARGTYPES = _MLA_ARGTYPES[:-1] + [_P, _P, _I, _P]
# q's dtype codes of the attention kernels (csrc/attn_common.cuh
# AttnDtype), which the grouped GEMM takes too (ops/grouped_matmul.py).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The cache's dtype codes of the attention kernels (csrc/attn_common.cuh
# KvDtype): 0 for q's own dtype, or an fp8 cache.
KV_CODES = {torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}
# Keys per shared-memory tile and warps per block of the kernel.
_TILE, _WARPS = 32, 8
# Query rows (tokens x query heads of one KV head) per work item, at most.
_MAX_ROWS = 128
# The tile widths of the tensor-core instances: a head_dim that is a
# multiple of 16 runs in the narrowest that holds it (``tc_width``).
TC_HEAD_DIMS = (64, 128, 256)
# MLA's latent head (kv_lora_rank 512 + rope 64): its own instances in bf16
# and fp16.
MLA_HEAD_DIM = 576
MLA_ROWS = 64  # query rows a block of the MLA instance (one wgmma M)
MLA_KEYS = 32  # keys a K or V tile of the MLA instances
MLA_STAGES = 2  # K and V tiles in flight (the ring's depth)


def kv_code(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> int:
    """The kernels' code of a cache of ``kv_dtype`` beside queries of
    ``q_dtype``: 0 for q's own dtype, 1 e4m3fn, 2 e5m2. Raises on any other
    pairing."""
    if kv_dtype == q_dtype:
        return 0
    if kv_dtype in KV_CODES:
        return KV_CODES[kv_dtype]
    raise NotImplementedError(
        f"a {kv_dtype} KV cache beside {q_dtype} queries: the cache holds "
        "the model's dtype or fp8 (e4m3fn, e5m2)")


def ragged_smem_bytes(block_q: int, group: int, hd: int) -> int:
    """Shared memory of one launch of the scalar instance whose blocks
    hold block_q * group query rows (the kernel's layout): q and acc for
    those rows, their m and l, a K tile padded to hd + 1 floats, a V tile
    and the warps' probabilities, all fp32."""
    rows = block_q * group
    return 4 * (2 * rows * hd + 2 * rows + _TILE * (hd + 1) + _TILE * hd
                + _WARPS * _TILE)


def _ragged_fit_rows(hd: int, smem_limit: int) -> int:
    """Query rows of the scalar instance that fit _MAX_ROWS and the card's
    shared memory: rows <= (limit/4 - 32(2hd+1) - 256) / (2hd+2)."""
    return min(_MAX_ROWS, (smem_limit // 4 - _TILE * (2 * hd + 1)
                           - _WARPS * _TILE) // (2 * hd + 2))


def ragged_block_q(group: int, hd: int, smem_limit: int) -> int:
    """Tokens per work item of the scalar instance: as many whole groups
    of query rows as fit (``_ragged_fit_rows``: 128 rows at hd 128, 80 at
    hd 256), else one token, whose rows the kernel cuts into slices
    (``ragged_block_rows``: 18 rows a block at MLA's head_dim 576). Raises,
    naming the bytes, when not even one row fits."""
    block_q = max(1, _ragged_fit_rows(hd, smem_limit) // group)
    rows = ragged_block_rows(group, hd, smem_limit, block_q)
    cuda_build.check_smem(
        f"ragged_paged_attention (group {group}, head_dim {hd}, "
        f"{block_q} tokens a work item, {rows} rows a block)",
        ragged_smem_bytes(1, rows, hd), smem_limit)
    return block_q


def ragged_block_rows(group: int, hd: int, smem_limit: int,
                      block_q: int) -> int:
    """Query rows a block of the scalar instance holds for work items of
    block_q tokens: all block_q * group of them where they fit, else as
    many as fit (at least one): the kernel then cuts an item's rows into
    slices (grid.z)."""
    return max(1, min(block_q * group, _ragged_fit_rows(hd, smem_limit)))


def ragged_uses_mla(dtype: torch.dtype, hd: int) -> bool:
    """Whether the kernel runs the MLA instance for this dtype (bf16 or
    fp16, head_dim 576)."""
    return dtype in (torch.bfloat16, torch.float16) and hd == MLA_HEAD_DIM


def mla_smem_bytes(fp8: bool = False) -> int:
    """Shared memory of a block of either MLA instance (``mla_attention.cuh``
    kSmem): Q (64 rows, 73,728 bytes) and a ring of two stages of a
    32-key K tile and a 32-key V tile (36,864 bytes each), 576 bf16 or
    fp16 a row in 128-byte swizzled chunks, or, on an fp8 cache, a ring of
    two stages of their staged bytes (18,432 each) and one K and one V
    tile of q's dtype to convert them into (the same 147,456 bytes); the
    window's hand-off of P from the warpgroup that computes S to the other
    two (P of a tile in q's dtype and its rows' rescale factors, two of
    each: 8,704 bytes); four
    mbarriers a stage and four for the hand-off; 1024 bytes to align the
    swizzle."""
    exchange = 2 * (MLA_ROWS * MLA_KEYS * 2 + MLA_ROWS * 4)
    tile = MLA_KEYS * MLA_HEAD_DIM  # a K or V tile's elements
    tiles = (2 * MLA_STAGES * tile + 2 * 2 * tile if fp8
             else 2 * MLA_STAGES * 2 * tile)
    return (2 * MLA_HEAD_DIM * MLA_ROWS + tiles + exchange
            + (4 * MLA_STAGES + 4) * 8 + 1024)


def mla_page_boxes(page: int) -> tuple[int, int]:
    """(rows a box, boxes a 32-key tile) of the MLA instances' TMA loads
    on pages of ``page`` tokens: a tile takes whole pages of 8 or 16
    tokens (each box 1024-byte aligned in the swizzle), one 32-row box of
    a page of any multiple of 32. Raises ``ValueError`` on another page
    size."""
    if page > 0 and page % MLA_KEYS == 0:
        return MLA_KEYS, 1
    if page in (8, 16):
        return page, MLA_KEYS // page
    raise ValueError(
        f"the MLA attention instances take pages of 8 or 16 tokens or a "
        f"multiple of {MLA_KEYS}, not {page}")


def ragged_mla_block_q(group: int, smem_limit: int,
                       kv_dtype: Optional[torch.dtype] = None) -> int:
    """Tokens per work item of the MLA instance: as many whole groups as
    fill its 64 rows (4 at V2-Lite's group of 16), else one token, whose
    group the kernel cuts into slices of 64 rows (V3's 128 query heads:
    two), in bf16 or fp16, on a cache of q's dtype or fp8 (``kv_dtype``)
    alike."""
    cuda_build.check_smem(
        f"ragged_paged_attention MLA instance (group {group}, head_dim "
        f"{MLA_HEAD_DIM})", mla_smem_bytes(kv_dtype in KV_CODES), smem_limit)
    return max(1, MLA_ROWS // group)


def tc_head_dim_ok(hd: int) -> bool:
    """Whether a head_dim runs on the tensor-core instances of the ragged
    and decode kernels: a multiple of 16 (an fp8 cache stages 16 values a
    16-byte copy, a k-step of mma.sync m16n8k16 takes 16) up to 256."""
    return hd % 16 == 0 and 16 <= hd <= TC_HEAD_DIMS[-1]


def tc_width(hd: int) -> int:
    """The width of the tensor-core instances' tiles for a head_dim: the
    narrowest of 64, 128 and 256 that holds it. The kernel strides by hd
    in global memory and skips the k-steps and n-tiles past it, so the
    padding costs shared memory and registers, not products. Raises on a
    head_dim past 256."""
    for w in TC_HEAD_DIMS:
        if hd <= w:
            return w
    raise ValueError(f"head_dim {hd} is past the tensor-core instances' "
                     f"widest tile, {TC_HEAD_DIMS[-1]}")


def ragged_uses_tensor_cores(dtype: torch.dtype, hd: int) -> bool:
    """Whether the kernel runs the tensor-core instance for this dtype
    (bf16 or fp16) and head_dim (``tc_head_dim_ok``)."""
    return dtype in (torch.bfloat16, torch.float16) and tc_head_dim_ok(hd)


def ragged_tc_rows(hd: int) -> int:
    """Query rows a block of the tensor-core instance: 4 warps of 32 rows
    in tiles up to 128 wide, of 16 in 256-wide ones."""
    return 128 if tc_width(hd) <= 128 else 64


def ragged_tc_smem_bytes(hd: int, fp8: bool = False) -> int:
    """Shared memory of the tensor-core instance (the kernel's TcCfg, by
    the tiles' width w = ``tc_width(hd)``): the block's Q rows and a ring of
    K and V tiles (64 keys, 32 at width 256; 3 stages at width 64, else
    2), 16-bit rows of w values padded by 8; an fp8 cache adds a ring of
    the same stages of staged bytes."""
    w = tc_width(hd)
    keys = 64 if w <= 128 else 32
    stages = 3 if w <= 64 else 2
    return (2 * (w + 8) * (ragged_tc_rows(hd) + stages * 2 * keys)
            + (stages * 2 * keys * w if fp8 else 0))


def ragged_tc_block_q(group: int, hd: int, smem_limit: int,
                      fp8: bool = False) -> int:
    """Tokens per work item of the tensor-core instance: as many whole
    groups of query rows as fit its rows (128 at head_dim <= 128, 64
    past). Raises when a group does not fit, or the ring (with an fp8
    cache's staging ring) does not fit the card's shared memory."""
    rows = ragged_tc_rows(hd)
    what = (f"ragged_paged_attention tensor-core instance (group {group}, "
            f"head_dim {hd})")
    if group > rows:
        raise RuntimeError(f"{what}: a token's {group} query rows exceed "
                           f"the block's {rows}")
    cuda_build.check_smem(what, ragged_tc_smem_bytes(hd, fp8), smem_limit)
    return rows // group


def ragged_route(dtype: torch.dtype, hd: int, spans: bool,
                 alibi: bool) -> tuple[str, str, str]:
    """(library, entry, instance) of the CUDA kernel that takes a call on
    the card: the library a ``csrc/<library>.cu``, the instance "mla",
    "tensor_cores" or "scalar" (``instance_launches``). Each option of the
    TPU kernel has an instance in every dtype: spans and ALiBi, alone or
    together, at every head_dim. The scalar instance takes fp32, and bf16
    or fp16 at a head_dim that is not a multiple of 16 (or past 256 but
    576)."""
    f16 = dtype == torch.float16
    if ragged_uses_mla(dtype, hd):
        if spans or alibi:
            return (("mla_opts_f16", "mla_ragged_opts_f16_launch", "mla")
                    if f16 else
                    ("mla_opts", "mla_ragged_opts_launch", "mla"))
        return (("mla_attention_f16", "mla_ragged_f16_launch", "mla") if f16
                else ("mla_attention", "mla_ragged_launch", "mla"))
    if ragged_uses_tensor_cores(dtype, hd):
        if spans:
            return (("ragged_spans_f16", "rpa_tc_spans_f16_launch",
                     "tensor_cores") if f16 else
                    ("ragged_spans", "rpa_tc_spans_launch", "tensor_cores"))
        return (("ragged_f16", "rpa_tc_f16_launch", "tensor_cores") if f16
                else ("ragged_paged_attention", "rpa_tc_launch",
                      "tensor_cores"))
    return "ragged_paged_attention", "rpa_launch", "scalar"


def ragged_work_item_tokens(dtype: torch.dtype, group: int, hd: int,
                            smem_limit: int,
                            kv_dtype: Optional[torch.dtype] = None) -> int:
    """block_q for the instance that ``dtype`` and ``hd`` run, on a cache
    of ``kv_dtype`` (None: q's dtype)."""
    if ragged_uses_mla(dtype, hd):
        return ragged_mla_block_q(group, smem_limit, kv_dtype)
    if ragged_uses_tensor_cores(dtype, hd):
        return ragged_tc_block_q(group, hd, smem_limit,
                                 kv_dtype in KV_CODES)
    return ragged_block_q(group, hd, smem_limit)


def ref_ragged_paged_attention(
    q: torch.Tensor,            # [T, nq, hd]
    cache_layer: torch.Tensor,  # [P, 2, kvh, page, hd]
    md: AttentionMetadata,
    scale: float,
    sliding_window: Optional[int] = None,
    logits_soft_cap: Optional[float] = None,
    chunk_attn: Optional[int] = None,
    alibi: Optional[torch.Tensor] = None,  # [nq] fp32 slopes
) -> torch.Tensor:
    """Plain PyTorch version (CPU path and the kernel's yardstick of
    correctness): per request, gather its pages and run a masked fp32
    softmax for its tokens (an fp8 cache's K/V upcast exactly). ALiBi
    adds slope[h * group + g] * (kv_pos - q_pos) to the scaled logit
    before the soft cap, with absolute positions (a chunk's queries sit
    past the keys of earlier chunks). Image spans (``md.mm_bidir_spans``)
    add to the causal mask the keys below seq_len that share a span with
    the query (the JAX oracle's mask, ``attention/backend.py:179-191``)."""
    _, _, kvh, page, hd = cache_layer.shape
    T, nq, _ = q.shape
    group = nq // kvh
    out = torch.zeros_like(q)
    max_kv = md.block_tables.shape[1] * page
    kv_pos = torch.arange(max_kv, device=q.device)
    for r in torch.unique(md.token_req_idx).tolist():
        idx = torch.nonzero(md.token_req_idx == r).flatten()
        kv = cache_layer[md.block_tables[r].long()]  # [MP, 2, kvh, page, hd]
        kv = kv.permute(1, 2, 0, 3, 4).reshape(2, kvh, max_kv, hd).float()
        qf = q[idx].float().reshape(len(idx), kvh, group, hd)
        logits = torch.einsum("thgd,hkd->thgk", qf, kv[0]) * scale
        pos = md.token_pos[idx].long()[:, None]
        if alibi is not None:
            slopes = alibi.float().reshape(kvh, group)
            logits = logits + (slopes[None, :, :, None]
                               * (kv_pos[None, :] - pos).float()[:, None,
                                                                 None, :])
        if logits_soft_cap is not None:
            logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
        mask = kv_pos[None, :] <= pos
        if md.mm_bidir_spans is not None:
            sp = md.mm_bidir_spans[r].long()                   # [M, 2]
            q_in = (sp[None, :, 0] <= pos) & (pos < sp[None, :, 1])
            k_in = ((sp[:, 0, None] <= kv_pos[None, :])
                    & (kv_pos[None, :] < sp[:, 1, None]))       # [M, K]
            bidir = (q_in[:, :, None] & k_in[None]).any(dim=1)  # [t, K]
            mask |= bidir & (kv_pos[None, :] < md.seq_lens[r].long())
        if sliding_window is not None:
            mask &= kv_pos[None, :] > pos - sliding_window
        if chunk_attn is not None:
            mask &= (kv_pos[None, :] // chunk_attn) == (pos // chunk_attn)
        logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
        probs = torch.softmax(logits, dim=-1).nan_to_num(0.0)
        o = torch.einsum("thgk,hkd->thgd", probs, kv[1])
        out[idx] = o.reshape(len(idx), nq, hd).to(q.dtype)
    return out


def ragged_paged_attention(
    q: torch.Tensor,          # [T, nq, hd]
    kv_cache: torch.Tensor,   # [L, P, 2, kvh, page, hd]
    layer: int,
    md: AttentionMetadata,
    scale: float,
    sliding_window: Optional[int] = None,
    logits_soft_cap: Optional[float] = None,
    chunk_attn: Optional[int] = None,
    alibi: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention output [T, nq, hd] in q's dtype. ``alibi``: [nq] fp32
    slopes on q's device, or None; ``md.mm_bidir_spans``: contiguous int32
    [R, M, 2] image spans on q's device, or None. The kernel reads the
    layer through its base pointer in the full cache: nothing is
    copied."""
    code = kv_code(q.dtype, kv_cache.dtype)
    cache_layer = kv_cache[layer]
    if q.device.type == "cpu":
        return ref_ragged_paged_attention(
            q, cache_layer, md, scale, sliding_window=sliding_window,
            logits_soft_cap=logits_soft_cap, chunk_attn=chunk_attn,
            alibi=alibi)
    if not q.is_cuda or q.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported query tensor: {q.device} {q.dtype}")
    if not (q.is_contiguous() and kv_cache.is_contiguous()):
        raise ValueError("q and the KV cache must be contiguous")
    T, nq, hd = q.shape
    _, _, kvh, page, hd_c = cache_layer.shape
    if hd_c != hd or nq % kvh:
        raise ValueError(f"bad geometry: q {tuple(q.shape)} cache "
                         f"{tuple(cache_layer.shape)}")
    int_args = (md.item_req, md.item_qstart, md.item_qlen, md.item_pos,
                md.seq_lens, md.block_tables)
    for t in int_args:
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
    slopes = alibi.data_ptr() if alibi is not None else None
    spans, num_spans = None, 0
    if md.mm_bidir_spans is not None:
        sp = md.mm_bidir_spans
        if (sp.dtype != torch.int32 or not sp.is_contiguous()
                or sp.device != q.device or sp.dim() != 3
                or sp.shape[0] != md.seq_lens.shape[0] or sp.shape[2] != 2
                or sp.shape[1] < 1):
            raise ValueError("mm_bidir_spans must be contiguous int32 [R, M, "
                             "2] on q's device, M >= 1")
        spans, num_spans = sp.data_ptr(), sp.shape[1]
    out = torch.empty_like(q)
    num_items = md.item_req.shape[0]
    if num_items == 0:
        return out
    group = nq // kvh
    what = (f"ragged_paged_attention (group {group}, head_dim {hd}, "
            f"{md.block_q} tokens a work item)")
    stream = cuda_build.stream(q.device)
    lib, sym, instance = ragged_route(q.dtype, hd, spans is not None,
                                      alibi is not None)
    if instance == "mla":
        for t in (q, cache_layer):
            if t.data_ptr() % 16:
                raise ValueError("q and the cache layer must be 16-byte "
                                 "aligned")
        mla_page_boxes(page)  # raises on a page size TMA cannot tile
        cuda_build.check_smem(what, mla_smem_bytes(code > 0),
                              cuda_build.smem_optin())
        args = (DTYPE_CODES[q.dtype], code, q.data_ptr(),
                cache_layer.data_ptr(), out.data_ptr(),
                *(t.data_ptr() for t in int_args), num_items,
                md.block_tables.shape[1], cache_layer.shape[0], nq, kvh, page,
                md.block_q, scale, sliding_window or 0, chunk_attn or 0,
                logits_soft_cap or 0.0)
        if lib.startswith("mla_opts"):
            err = cuda_build.entry(lib, sym, _MLA_OPTS_ARGTYPES)(
                *args, slopes, spans, num_spans, stream)
        else:
            err = cuda_build.entry(lib, sym, _MLA_ARGTYPES)(*args, stream)
    elif instance == "tensor_cores":
        if md.block_q * group > ragged_tc_rows(hd):
            raise ValueError(f"{what}: more rows than the tensor-core "
                             "instance's block (size block_q with "
                             "ragged_work_item_tokens)")
        for t in (q, cache_layer):
            if t.data_ptr() % 16:
                raise ValueError("q and the cache layer must be 16-byte "
                                 "aligned")
        cuda_build.check_smem(what, ragged_tc_smem_bytes(hd, code > 0),
                              cuda_build.smem_optin())
        err = cuda_build.entry(lib, sym, _TC_ARGTYPES)(
            DTYPE_CODES[q.dtype], code, q.data_ptr(), cache_layer.data_ptr(),
            out.data_ptr(), *(t.data_ptr() for t in int_args), num_items,
            md.block_tables.shape[1], nq, kvh, page, hd, md.block_q, scale,
            sliding_window or 0, chunk_attn or 0, logits_soft_cap or 0.0,
            slopes, spans, num_spans, stream)
    else:
        smem_limit = cuda_build.smem_optin()
        rows = ragged_block_rows(group, hd, smem_limit, md.block_q)
        smem = ragged_smem_bytes(1, rows, hd)
        cuda_build.check_smem(what, smem, smem_limit)
        err = cuda_build.entry(lib, sym, _ARGTYPES)(
            DTYPE_CODES[q.dtype], code, q.data_ptr(), cache_layer.data_ptr(),
            out.data_ptr(), *(t.data_ptr() for t in int_args), num_items,
            md.block_tables.shape[1], nq, kvh, page, hd, md.block_q, rows,
            scale, sliding_window or 0, chunk_attn or 0,
            logits_soft_cap or 0.0, slopes, spans, num_spans, smem, stream)
    cuda_build.check(err, "ragged_paged_attention launch")
    ragged_paged_attention.launches += 1
    ragged_paged_attention.instance_launches[instance] += 1
    ragged_paged_attention.source_launches[lib] += 1
    ragged_paged_attention.dtype_launches[str(q.dtype).removeprefix(
        "torch.")] += 1
    if spans is not None:
        ragged_paged_attention.span_launches += 1
    return out


# Launches of the CUDA kernel (a run sets it to 0 and reads it after), in
# all, by instance, by library (``ragged_route``'s: the csrc/<library>.cu
# it was built from), by q's dtype, and those with image spans.
ragged_paged_attention.launches = 0
ragged_paged_attention.instance_launches = {"tensor_cores": 0, "mla": 0,
                                            "scalar": 0}
ragged_paged_attention.source_launches = dict.fromkeys(
    ("ragged_paged_attention", "ragged_f16", "ragged_spans",
     "ragged_spans_f16", "mla_attention", "mla_attention_f16", "mla_opts",
     "mla_opts_f16"), 0)
ragged_paged_attention.dtype_launches = {"float32": 0, "bfloat16": 0,
                                         "float16": 0}
ragged_paged_attention.span_launches = 0


def reset_launches() -> None:
    """Set every launch count of ``ragged_paged_attention`` to 0."""
    f = ragged_paged_attention
    f.launches = f.span_launches = 0
    for table in (f.instance_launches, f.source_launches, f.dtype_launches):
        table.update(dict.fromkeys(table, 0))
