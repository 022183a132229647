"""Ragged paged attention for prefill and mixed waves.

``ragged_paged_attention`` launches the hand-written CUDA kernel
(``csrc/ragged_paged_attention.cu``, which replaces the TPU kernel
``aphrodite_tpu/ops/ragged_paged_attention.py:_rpa_kernel``) on CUDA
tensors, and runs the plain PyTorch version ``ref_ragged_paged_attention``
on CPU tensors. bf16 at head_dim 64, 128 or 256 runs the tensor-core
instance (``rpa_tc_launch``), everything else the scalar one
(``rpa_launch``), which keeps fp32 in full fp32; each is sized by its own
function and the runner asks ``ragged_work_item_tokens`` for the one that
the model's dtype will run. Query token i of request r at position p attends to the
request's KV positions j <= p, read through its block table from one layer
of the paged cache, optionally restricted by a sliding window or chunked
local attention, with an optional logit soft cap and ALiBi: the bias
slope[h] * (j - p) on the scaled logit, before the soft cap, as the TPU
kernel adds it (``ragged_paged_attention.py:201-216``; the JAX oracle
``attention/backend.py`` adds it after the cap, so the two agree only
without one).

The cache holds q's dtype or fp8 (e4m3fn or e5m2): both instances upcast
an fp8 K/V tile to q's dtype before both products, as the TPU kernel does
(the tensor-core instance through a ring of staged bytes, sized by
``ragged_tc_smem_bytes(hd, fp8=True)``); the plain version computes in
fp32, where every fp8 value is exact.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.ops import cuda_build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
             _I, _I, _I, _F, _I, _I, _F, _P, _I, _P]
_TC_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                _I, _I, _F, _I, _I, _F, _P, _P]
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The cache's dtype codes of the attention kernels (csrc/attn_common.cuh
# KvDtype): 0 for q's own dtype, or an fp8 cache.
KV_CODES = {torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}
# Keys per shared-memory tile and warps per block of the kernel.
_TILE, _WARPS = 32, 8
# Query rows (tokens x query heads of one KV head) per work item, at most.
_MAX_ROWS = 128
# The head dims of the tensor-core instance.
TC_HEAD_DIMS = (64, 128, 256)


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
    """Shared memory of one launch (the kernel's layout): q and acc for
    block_q * group rows, their m and l, a K tile padded to hd + 1 floats,
    a V tile and the warps' probabilities, all fp32."""
    rows = block_q * group
    return 4 * (2 * rows * hd + 2 * rows + _TILE * (hd + 1) + _TILE * hd
                + _WARPS * _TILE)


def ragged_block_q(group: int, hd: int, smem_limit: int) -> int:
    """Tokens per work item: as many whole groups of query rows as fit both
    _MAX_ROWS and the card's shared memory, rows <= (limit/4 - 32(2hd+1)
    - 256) / (2hd+2): 128 rows at hd 128, 80 at hd 256. Raises, naming the
    bytes, when not even one token fits."""
    fit = ((smem_limit // 4 - _TILE * (2 * hd + 1) - _WARPS * _TILE)
           // (2 * hd + 2))
    block_q = max(1, min(_MAX_ROWS, fit) // group)
    cuda_build.check_smem(
        f"ragged_paged_attention (group {group}, head_dim {hd}, "
        f"{block_q} tokens a work item)",
        ragged_smem_bytes(block_q, group, hd), smem_limit)
    return block_q


def ragged_uses_tensor_cores(dtype: torch.dtype, hd: int) -> bool:
    """Whether the kernel runs the tensor-core instance for this dtype."""
    return dtype == torch.bfloat16 and hd in TC_HEAD_DIMS


def ragged_tc_rows(hd: int) -> int:
    """Query rows a block of the tensor-core instance: 4 warps of 32 rows
    at head_dim <= 128, of 16 at 256."""
    return 128 if hd <= 128 else 64


def ragged_tc_smem_bytes(hd: int, fp8: bool = False) -> int:
    """Shared memory of the tensor-core instance (the kernel's TcCfg): the
    block's Q rows and a ring of K and V tiles (64 keys, 32 at head_dim
    256; 3 stages at head_dim 64, else 2), bf16 rows padded by 8; an fp8
    cache adds a ring of the same stages of staged bytes."""
    keys = 64 if hd <= 128 else 32
    stages = 3 if hd <= 64 else 2
    return (2 * (hd + 8) * (ragged_tc_rows(hd) + stages * 2 * keys)
            + (stages * 2 * keys * hd if fp8 else 0))


def ragged_tc_block_q(group: int, hd: int, smem_limit: int,
                      fp8: bool = False) -> int:
    """Tokens per work item of the tensor-core instance: as many whole
    groups of query rows as fit its rows (128 at head_dim <= 128, 64 at
    256). Raises when a group does not fit, or the ring (with an fp8
    cache's staging ring) does not fit the card's shared memory."""
    rows = ragged_tc_rows(hd)
    what = (f"ragged_paged_attention tensor-core instance (group {group}, "
            f"head_dim {hd})")
    if group > rows:
        raise RuntimeError(f"{what}: a token's {group} query rows exceed "
                           f"the block's {rows}")
    cuda_build.check_smem(what, ragged_tc_smem_bytes(hd, fp8), smem_limit)
    return rows // group


def ragged_work_item_tokens(dtype: torch.dtype, group: int, hd: int,
                            smem_limit: int,
                            kv_dtype: Optional[torch.dtype] = None) -> int:
    """block_q for the instance that ``dtype`` and ``hd`` run, on a cache
    of ``kv_dtype`` (None: q's dtype)."""
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
    past the keys of earlier chunks)."""
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
    mm_bidir_spans: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention output [T, nq, hd] in q's dtype. ``alibi``: [nq] fp32
    slopes on q's device, or None. The kernel reads the layer through its
    base pointer in the full cache: nothing is copied."""
    if mm_bidir_spans is not None:
        raise NotImplementedError(
            "bidirectional image spans are not ported to the ragged "
            "attention kernel yet: they come with PaliGemma and Gemma-3 "
            "multimodal (ROADMAP A13)")
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
    out = torch.empty_like(q)
    num_items = md.item_req.shape[0]
    if num_items == 0:
        return out
    group = nq // kvh
    what = (f"ragged_paged_attention (group {group}, head_dim {hd}, "
            f"{md.block_q} tokens a work item)")
    stream = cuda_build.stream(q.device)
    if ragged_uses_tensor_cores(q.dtype, hd):
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
        launch = cuda_build.entry("ragged_paged_attention", "rpa_tc_launch",
                                  _TC_ARGTYPES)
        err = launch(
            code, q.data_ptr(), cache_layer.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in int_args), num_items,
            md.block_tables.shape[1], nq, kvh, page, hd, md.block_q, scale,
            sliding_window or 0, chunk_attn or 0, logits_soft_cap or 0.0,
            slopes, stream)
    else:
        smem = ragged_smem_bytes(md.block_q, group, hd)
        cuda_build.check_smem(what, smem, cuda_build.smem_optin())
        launch = cuda_build.entry("ragged_paged_attention", "rpa_launch",
                                  _ARGTYPES)
        err = launch(
            DTYPE_CODES[q.dtype], code, q.data_ptr(), cache_layer.data_ptr(),
            out.data_ptr(), *(t.data_ptr() for t in int_args), num_items,
            md.block_tables.shape[1], nq, kvh, page, hd, md.block_q, scale,
            sliding_window or 0, chunk_attn or 0, logits_soft_cap or 0.0,
            slopes, smem, stream)
    cuda_build.check(err, "ragged_paged_attention launch")
    ragged_paged_attention.launches += 1
    return out


# Launches of the CUDA kernel (a run sets it to 0 and reads it after).
ragged_paged_attention.launches = 0
