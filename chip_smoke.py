#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``aphrodite_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and nothing of JAX. Phases, each fatal on failure:

1. Print the card's name and power limit; build the CUDA kernels from
   ``aphrodite_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel).
2. Hold each kernel against its plain PyTorch version at the main paths'
   shapes, in bf16 and fp32, and time kernel, plain version and a library
   yardstick that the port itself never calls: both attention kernels at
   the Qwen2.5-1.5B and at the Llama-3.1-8B path's heads, prefill wave and
   decode window, against ``scaled_dot_product_attention`` over gathered
   dense K/V; the quantized GEMMs (Llama-3.1-8B decode shapes for the
   packed W4 kernel, Qwen2.5-1.5B shapes for the unpacked W4 and the W8
   kernel) against ``torch._weight_int4pack_mm`` /
   ``torch._weight_int8pack_mm`` where the card's torch has them, else
   ``torch.matmul`` on the dequantized weight. Also time the W4 prefill
   product (M > 256) at the 8B wave's shapes.
3. Run a tiny model end to end in fp32 through the port's ``LLM`` on the
   card and on the CPU with the same weights: greedy tokens must be equal.
4. Qwen2.5-1.5B geometry, bf16 dummy weights, block 64, max_num_seqs 32,
   64 prompts x (500 + 50) greedy through ``LLM.generate``; one warm-up
   run, then timed runs and a profiled run. Exactly 3200 tokens must come
   out and both attention kernels must have been launched.
5. Quantized parity: Qwen2.5-1.5B widths at 2 layers, fp32, gptq (the
   unpacked W4 kernel) and w8a16 (the W8 kernel), card vs CPU with the
   same quantized weights: greedy tokens must be equal and each kernel
   launched.
6. The main path of the quantized slice: Llama-3.1-8B at full width,
   W4A16 (gptq, group 128; every projection packed), bf16, 32 prompts x
   (512 + 64) greedy; one warm-up, 3 cold runs (prefix cache reset before
   each), 3 warm runs, one profiled run. Exactly 2048 tokens a run; the
   packed W4 kernel and both attention kernels must have been launched.
7. MoE parity: a tiny Qwen2-MoE (8 experts, top-2, a gated shared expert,
   one dense layer) in fp32, card vs CPU with the same weights: greedy
   tokens must be equal and the grouped GEMM launched.
8. The main path of the MoE slice: Qwen1.5-MoE-A2.7B at full width and
   depth (60 experts, top-4), bf16, the same traffic and runs as phase 6.
   Exactly 2048 tokens a run; the grouped GEMM and both attention kernels
   must have been launched.
9. SSM parity: a tiny Mamba, FalconMamba and Mamba-2 in fp32 (weights
   redrawn at fan-in scale), card vs CPU with the same weights, chunked
   prefill at a 16-token budget and decode windows: greedy tokens must be
   equal and the selective scan launched.
10. The main path of the SSM slice: Mamba-2.8B (``state-spaces/
   mamba-2.8b-hf``) at full width and depth, bf16, a 4096-token batch
   budget, phase 6's traffic. Prefix caching is off for recurrent-state
   models, so every run is cold: one warm-up, 3 timed runs, one profiled
   run. Exactly 2048 tokens and no cached prompt token a run; the scan
   launched 64 times (once a layer) for every forward of the runner.
11. Gemma parity: a tiny Gemma-2 (head_dim 256) and Gemma-3 (MQA, linear
   rope on its global layer) in fp32 with a 16-token sliding window and
   soft caps, card vs CPU with the same weights, prompts past the window,
   16-step decode windows: greedy tokens must be equal and the decode
   kernel launched.
12. The main path of the Gemma slice: Gemma-2-9B (``google/gemma-2-9b``)
   at full width and depth, bf16, phase 6's traffic and runs. Exactly 2048
   tokens a run; decode runs the non-window multi-step path, so in every
   cold and warm run the decode kernel launches 42 x 63 = 2646 times, the
   ragged kernel 42 times and the window kernel never.

Phase 2 also holds the grouped GEMM (which stands in for the megablox
``gmm`` TPU kernel) against its plain version at phase 8's shapes: one
prefill wave's 65536 sorted rows over 60 experts, gate|up and down, with
balanced (random top-4) and skewed group sizes (empty groups, one group
holding ~45 % of the rows), and at M = 240, where the grouped route
starts; yardstick ``torch._grouped_mm`` where the card's torch has it.
It holds the decode kernel (which stands in for the TPU
``decode_paged_attention``) in bf16 and fp32 at phase 12's decode step
(32 rows, 16 / 8 heads of 256, contexts 513-576, soft cap 50), with a
256-token sliding window over ~1030-token contexts, and with ALiBi and
chunked local attention at head_dim 128, against
``scaled_dot_product_attention`` over gathered dense K/V; and the ragged
and window kernels at head_dim 256 (phase 12's heads).
It holds the selective scan (which stands in for the TPU
``selective_scan``) against its plain version in fp32, where the two must
be equal bit for bit, at phase 10's shapes (a 4096-token wave of 8
segments of 512 and a 32-row decode step, over 5120 x 16 columns) and at
a ragged edge; no single PyTorch call computes the recurrence, so it has
no library yardstick.

The last lines are the kernels' JSON record (one row per kernel and path
that runs it, with that path's launches and shapes), the card line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import bisect
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM (NVIDIA data sheet)
PEAK_OPS = {"bfloat16": 989e12,  # dense bf16 tensor cores
            "float32": 67e12}    # fp32 outside the tensor cores
PAGE, HD = 64, 128
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max-abs, outputs are O(1)

LLAMA31_8B = dict(  # meta-llama/Llama-3.1-8B config.json
    vocab_size=128256, hidden_size=4096, num_hidden_layers=32,
    num_attention_heads=32, num_key_value_heads=8, head_dim=128,
    intermediate_size=14336, rms_norm_eps=1e-5, rope_theta=500000.0,
    rope_scaling={"rope_type": "llama3", "factor": 8.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192},
    max_position_embeddings=131072, tie_word_embeddings=False,
    architectures=["LlamaForCausalLM"])
# (K, N) of a layer's four GEMMs with QKV and gate/up fused, M = 32.
LLAMA8B_GEMMS = {"qkv": (4096, 6144), "o": (4096, 4096),
                 "gate_up": (4096, 28672), "down": (14336, 4096)}
QWEN_GEMMS = {"qkv": (1536, 2048), "o": (1536, 1536),
              "gate_up": (1536, 17920), "down": (8960, 1536)}
QUANT_KERNELS = {  # name: (replaces, shapes)
    "w4a16_packed_matmul": (
        "aphrodite_tpu/ops/quant_matmul_pallas.py:206", LLAMA8B_GEMMS),
    "w4a16_matmul": (
        "aphrodite_tpu/ops/quant_matmul_pallas.py:119", QWEN_GEMMS),
    "w8a16_matmul": (
        "aphrodite_tpu/ops/quant_matmul_pallas.py:50", QWEN_GEMMS),
}

# Attention shapes of each path's run: heads, one prefill wave's (context,
# query) lengths per request, one decode window's paged lengths.
ATTN_GEOMS = {
    "qwen2.5-1.5b-bf16": dict(  # phase 4: 28 prompts + 4 decode rows
        nq=12, kvh=2, ctx=[500] * 28 + [521, 527, 533, 540],
        qlen=[500] * 28 + [1] * 4,
        paged=[500 + (37 * r) % 51 for r in range(32)]),
    "llama-3.1-8b-w4a16": dict(  # phase 6: 32 x 512 in one wave
        nq=32, kvh=8, ctx=[512] * 32, qlen=[512] * 32, paged=[512] * 32),
    "qwen1.5-moe-a2.7b-bf16": dict(  # phase 8: 32 x 512 in one wave
        nq=16, kvh=16, ctx=[512] * 32, qlen=[512] * 32, paged=[512] * 32),
    # phase 12: 32 x 512 in one wave at head_dim 256 (the ragged kernel's
    # 80-row items, the window kernel's 2-warp blocks; Gemma decodes on
    # the decode kernel, so the window kernel is held here only)
    "gemma-2-9b-bf16": dict(
        nq=16, kvh=8, hd=256, ctx=[512] * 32, qlen=[512] * 32,
        paged=[512] * 32),
}

QWEN15_MOE_A27B = dict(  # Qwen/Qwen1.5-MoE-A2.7B config.json
    vocab_size=151936, hidden_size=2048, num_hidden_layers=24,
    num_attention_heads=16, num_key_value_heads=16, intermediate_size=5632,
    moe_intermediate_size=1408, shared_expert_intermediate_size=5632,
    num_experts=60, num_experts_per_tok=4, norm_topk_prob=False,
    decoder_sparse_step=1, mlp_only_layers=[], rope_theta=1000000.0,
    rms_norm_eps=1e-6, max_position_embeddings=8192, use_sliding_window=False,
    tie_word_embeddings=False, architectures=["Qwen2MoeForCausalLM"])
# (K, N) of a MoE layer's two grouped GEMMs (gate|up fused on N).
MOE_GEMMS = {"gate_up": (2048, 2 * 1408), "down": (1408, 2048)}
MOE_E, MOE_K = 60, 4

MAMBA_2P8B = dict(  # state-spaces/mamba-2.8b-hf config.json
    vocab_size=50280, hidden_size=2560, num_hidden_layers=64,
    intermediate_size=5120, state_size=16, conv_kernel=4,
    time_step_rank=160, use_conv_bias=True, use_bias=False,
    layer_norm_epsilon=1e-5, tie_word_embeddings=True, model_type="mamba",
    architectures=["MambaForCausalLM"])
SCAN_COLUMNS = 5120 * 16  # d_inner x d_state of a Mamba-2.8B layer

QWEN25_1P5B = dict(
    vocab_size=151936, hidden_size=1536, num_hidden_layers=28,
    num_attention_heads=12, num_key_value_heads=2, intermediate_size=8960,
    max_position_embeddings=4096, rope_theta=1000000.0, rms_norm_eps=1e-6,
    tie_word_embeddings=True, use_sliding_window=False,
    architectures=["Qwen2ForCausalLM"])


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_cache(gen, ctx_lens, dtype, kvh, num_layers=2, hd=HD):
    """Random [L, P, 2, kvh, page, hd] cache and shuffled block tables
    covering ctx_lens tokens per request."""
    import torch
    pages_per = [-(-n // PAGE) for n in ctx_lens]
    max_pages = max(pages_per)
    num_pages = sum(pages_per) + 1
    cache = torch.randn((num_layers, num_pages, 2, kvh, PAGE, hd),
                        generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    bt = torch.zeros((len(ctx_lens), max_pages), dtype=torch.int32,
                     device="cuda")
    o = 0
    for r, n in enumerate(pages_per):
        bt[r, :n] = perm[o:o + n].int()
        o += n
    return cache, bt


def dense_kv(cache_layer, bt, ctx_lens, s_max):
    """Gather each request's K/V into dense [R, kvh, s_max, hd]."""
    R, kvh, hd = len(ctx_lens), cache_layer.shape[2], cache_layer.shape[-1]
    kv = cache_layer[bt.long()]                 # [R, MP, 2, kvh, page, hd]
    kv = kv.permute(0, 2, 3, 1, 4, 5).reshape(R, 2, kvh, -1, hd)
    return kv[:, 0, :, :s_max].contiguous(), kv[:, 1, :, :s_max].contiguous()


def check_ragged(gen, dtype_name: str, geom: dict) -> dict:
    """Kernel A on one prefill/mixed wave of a path (``ATTN_GEOMS``)."""
    import torch
    import torch.nn.functional as F
    from aphrodite_tpu_torch.attention.metadata import (AttentionMetadata,
                                                        build_work_items)
    from aphrodite_tpu_torch.ops import cuda_build
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_block_q, ragged_paged_attention, ref_ragged_paged_attention)
    dtype = getattr(torch, dtype_name)
    NQ, KVH, ctx, qn = geom["nq"], geom["kvh"], geom["ctx"], geom["qlen"]
    HD = geom.get("hd", 128)
    cache, bt = paged_cache(gen, ctx, dtype, KVH, hd=HD)
    R, T = len(ctx), sum(qn)
    qsl = np.concatenate([[0], np.cumsum(qn)]).astype(np.int32)
    tok_req = np.repeat(np.arange(R), qn).astype(np.int32)
    tok_pos = np.concatenate([np.arange(c - n, c) for c, n in zip(ctx, qn)])
    block_q = ragged_block_q(NQ // KVH, HD, cuda_build.smem_optin())
    items = build_work_items(qsl[:-1], np.diff(qsl),
                             np.asarray(ctx, np.int32), R, block_q)
    dev = lambda a: torch.from_numpy(np.asarray(a)).cuda()  # noqa: E731
    md = AttentionMetadata(
        token_req_idx=dev(tok_req), token_pos=dev(tok_pos.astype(np.int32)),
        slot_mapping=None,
        seq_lens=dev(np.asarray(ctx, np.int32)), block_tables=bt,
        block_q=block_q, **{k: dev(v) for k, v in items.items()})
    q = torch.randn((T, NQ, HD), generator=gen, device="cuda").to(dtype)
    scale = HD ** -0.5
    layer = 1
    out = ragged_paged_attention(q, cache, layer, md, scale)
    ref = ref_ragged_paged_attention(q, cache[layer], md, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not (err <= TOL[dtype_name] and torch.isfinite(out).all()):
        raise AssertionError(f"ragged kernel {dtype_name}: max_abs_err "
                             f"{err} > {TOL[dtype_name]}")
    ms = cuda_ms(lambda: ragged_paged_attention(q, cache, layer, md, scale),
                 20)
    plain_ms = cuda_ms(
        lambda: ref_ragged_paged_attention(q, cache[layer], md, scale), 2)
    # Library yardstick: one SDPA call over the wave padded to a dense
    # [R, nq, max qlen, hd] batch with a [R, 1, max qlen, S] mask.
    s_max, lq = max(ctx), max(qn)
    k_d, v_d = dense_kv(cache[layer], bt, ctx, s_max)
    q_d = torch.zeros((R, NQ, lq, HD), dtype=dtype, device="cuda")
    mask = torch.zeros((R, 1, lq, s_max), dtype=torch.bool, device="cuda")
    kv_pos = torch.arange(s_max, device="cuda")
    for r in range(R):
        a, b = int(qsl[r]), int(qsl[r + 1])
        q_d[r, :, :b - a] = q[a:b].transpose(0, 1)
        pos = torch.arange(ctx[r] - (b - a), ctx[r], device="cuda")
        mask[r, 0, :b - a] = kv_pos[None, :] <= pos[:, None]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q_d, k_d, v_d, attn_mask=mask, scale=scale, enable_gqa=True), 5)
    item = torch.finfo(dtype).bits // 8
    vis = sum(int(p) + 1 for p in tok_pos)   # causal keys per token
    nbytes = item * (2 * T * NQ * HD + 2 * KVH * HD * sum(ctx))
    ops = 4.0 * NQ * HD * vis
    b_ms, b_by = bound_ms(nbytes, ops, dtype_name)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def check_window(gen, dtype_name: str, geom: dict) -> dict:
    """Kernel B on one decode window of a path (``ATTN_GEOMS``): its paged
    lengths with a 64-slot tail, at several window steps."""
    import torch
    import torch.nn.functional as F
    from aphrodite_tpu_torch.ops.window_decode_attention import (
        ref_window_decode_attention, window_decode_attention)
    dtype = getattr(torch, dtype_name)
    NQ, KVH, plens = geom["nq"], geom["kvh"], geom["paged"]
    HD = geom.get("hd", 128)
    R, Kw, layer = len(plens), 64, 1
    cache, bt = paged_cache(gen, [p + Kw for p in plens], dtype, KVH, hd=HD)
    tail_k = torch.randn((2, R, KVH, Kw, HD), generator=gen,
                         device="cuda").to(dtype)
    tail_v = torch.randn((2, R, KVH, Kw, HD), generator=gen,
                         device="cuda").to(dtype)
    q = torch.randn((R, NQ, HD), generator=gen, device="cuda").to(dtype)
    pl = torch.tensor(plens, dtype=torch.int32, device="cuda")
    scale = HD ** -0.5
    err = 0.0
    for step in (0, 1, 31, 48, 63):
        out = window_decode_attention(q, cache, tail_k, tail_v, layer, step,
                                      pl, bt, scale)
        ref = ref_window_decode_attention(q, cache[layer], tail_k[layer],
                                          tail_v[layer], step, pl, bt, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError("window kernel: non-finite output")
        err = max(err, (out.float() - ref.float()).abs().max().item())
    if err > TOL[dtype_name]:
        raise AssertionError(f"window kernel {dtype_name}: max_abs_err "
                             f"{err} > {TOL[dtype_name]}")
    step = 24  # the middle of a 49-step window
    ms = cuda_ms(lambda: window_decode_attention(
        q, cache, tail_k, tail_v, layer, step, pl, bt, scale), 200)
    plain_ms = cuda_ms(lambda: ref_window_decode_attention(
        q, cache[layer], tail_k[layer], tail_v[layer], step, pl, bt, scale),
        5)
    # Library yardstick: SDPA over dense [R, kvh, S + Kw, hd] with a mask.
    s_max = max(plens)
    k_p, v_p = dense_kv(cache[layer], bt, plens, s_max)
    k_d = torch.cat([k_p, tail_k[layer]], dim=2)
    v_d = torch.cat([v_p, tail_v[layer]], dim=2)
    j = torch.arange(s_max + Kw, device="cuda")
    mask = torch.where(j[None, :] < s_max, j[None, :] < pl[:, None].long(),
                       (j[None, :] - s_max) <= step)[:, None, None, :]
    q_d = q[:, :, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q_d, k_d, v_d, attn_mask=mask, scale=scale, enable_gqa=True), 50)
    item = torch.finfo(dtype).bits // 8
    vis = sum(plens) + R * (step + 1)
    nbytes = item * (2 * R * NQ * HD + 2 * KVH * HD * vis)
    ops = 4.0 * NQ * HD * vis
    b_ms, b_by = bound_ms(nbytes, ops, dtype_name)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


# Decode kernel cases: (heads, head_dim, context lengths, options). The
# Gemma-2-9B path's decode step (contexts 513-576 while 32 requests decode
# 64 tokens after 512-token prompts; soft cap 50), the same with a 256-token
# sliding window over ~1030-token contexts (so the mask bites), and ALiBi
# and chunked local attention at head_dim 128.
DECODE_CASES = {
    "gemma-2-9b": (16, 8, 256, [513 + (37 * r) % 64 for r in range(32)],
                   dict(logits_soft_cap=50.0)),
    "gemma-2-9b-window": (16, 8, 256, [1000 + (37 * r) % 64
                                       for r in range(32)],
                          dict(logits_soft_cap=50.0, sliding_window=256)),
    "alibi-hd128": (16, 8, 128, [513 + (37 * r) % 64 for r in range(32)],
                    dict(alibi=True)),
    "chunk-hd128": (16, 8, 128, [1000 + (37 * r) % 64 for r in range(32)],
                    dict(chunk_attn=256)),
}


def check_decode(gen, dtype_name: str, case: str) -> dict:
    """The decode kernel on one case of ``DECODE_CASES``: error against
    its plain version, kernel and plain times, the bound (each visible K/V
    row read once, q read and the output written once) and the yardstick,
    one ``scaled_dot_product_attention`` call over K/V gathered into dense
    [R, kvh, S, hd] with the same mask (ALiBi as an additive bias; SDPA has
    no soft cap, so it computes the uncapped function there)."""
    import torch
    import torch.nn.functional as F
    from aphrodite_tpu_torch.ops.decode_paged_attention import (
        decode_paged_attention, ref_decode_paged_attention)
    dtype = getattr(torch, dtype_name)
    nq, kvh, hd, ctx, opts = DECODE_CASES[case]
    opts = dict(opts)
    if opts.pop("alibi", False):  # the JAX package's slopes for 16 heads
        opts["alibi"] = torch.tensor([2.0 ** (-0.5 * (h + 1))
                                      for h in range(nq)], device="cuda")
    R, layer = len(ctx), 1
    cache, bt = paged_cache(gen, ctx, dtype, kvh, hd=hd)
    sl = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    q = torch.randn((R, nq, hd), generator=gen, device="cuda").to(dtype)
    scale = hd ** -0.5
    out = decode_paged_attention(q, cache, layer, bt, sl, scale, **opts)
    ref = ref_decode_paged_attention(q, cache[layer], bt, sl, scale, **opts)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not (err <= TOL[dtype_name] and torch.isfinite(out).all()):
        raise AssertionError(f"decode kernel {case} {dtype_name}: "
                             f"max_abs_err {err} > {TOL[dtype_name]}")
    ms = cuda_ms(lambda: decode_paged_attention(q, cache, layer, bt, sl,
                                                scale, **opts), 200)
    plain_ms = cuda_ms(lambda: ref_decode_paged_attention(
        q, cache[layer], bt, sl, scale, **opts), 5)
    s_max = max(ctx)
    k_d, v_d = dense_kv(cache[layer], bt, ctx, s_max)
    j = torch.arange(s_max, device="cuda")[None, :]
    pos = (sl.long() - 1)[:, None]
    keep = j <= pos
    if "sliding_window" in opts:
        keep &= j > pos - opts["sliding_window"]
    if "chunk_attn" in opts:
        keep &= j // opts["chunk_attn"] == pos // opts["chunk_attn"]
    mask = keep[:, None, None, :]
    if "alibi" in opts:
        mask = torch.where(mask, opts["alibi"][None, :, None, None]
                           * (j - pos).float()[:, None, None, :],
                           float("-inf")).to(dtype)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], k_d, v_d, attn_mask=mask, scale=scale,
        enable_gqa=True), 50)
    vis = int(keep.sum().item())   # K/V rows this run's masks let in
    item = torch.finfo(dtype).bits // 8
    nbytes = item * (2 * R * nq * hd + 2 * kvh * hd * vis)
    ops = 4.0 * nq * hd * vis
    b_ms, b_by = bound_ms(nbytes, ops, dtype_name)
    log(f"# phase 2: decode_paged_attention {case} {dtype_name} (R {R}, nq "
        f"{nq}, kvh {kvh}, hd {hd}, contexts {min(ctx)}-{max(ctx)}, "
        f"{opts if 'alibi' not in opts else 'alibi'}): max_abs_err "
        f"{err:.3g} (tol {TOL[dtype_name]}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}, {vis} K/V rows), {nbytes / ms / 1e6:.0f} GB/s")
    del cache, k_d, v_d, ref
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def quant_inputs(gen, name: str, K: int, N: int, M: int, dtype):
    """Random quantized weights and x scaled so that y is O(1) (standard
    deviation ~0.25: (q - z) has deviation ~6.5, int8 q ~73.6): x, the
    kernel's weight arguments, the plain version, and the dense fp32 W."""
    import torch
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    from aphrodite_tpu_torch.quantization.loader import pack_w4
    dev = dict(device="cuda", generator=gen)
    x = torch.randn((M, K), **dev).to(dtype)
    if name == "w8a16_matmul":
        q = torch.randint(-127, 128, (K, N), **dev).to(torch.int8)
        s = (0.5 + torch.rand((N,), **dev)) / (4 * 73.6 * K ** 0.5)
        args = (q, s)
        dense = q.float() * s
        plain = lambda xf: qm.ref_w8a16_matmul(xf, q, s)  # noqa: E731
    else:
        G = K // 128
        q = torch.randint(0, 16, (K, N), **dev).to(torch.int8)
        z = torch.randint(0, 16, (G, N), **dev).float()
        s = (0.5 + torch.rand((G, N), **dev)) / (4 * 6.5 * K ** 0.5)
        args = ((pack_w4(q) if name == "w4a16_packed_matmul" else q), s, z)
        dense = qm.dequant_w4(q, s, z)
        plain = lambda xf: qm.ref_w4a16_matmul(xf, q, s, z)  # noqa: E731
    return x, args, plain, dense


def library_call(name: str, x, args, dense):
    """(label, fn): one PyTorch call computing the same product, which the
    port never calls."""
    import torch
    if x.dtype == torch.bfloat16:
        try:
            if name == "w8a16_matmul":
                q, s = args
                qt, sb = q.t().contiguous(), s.to(torch.bfloat16)
                fn = lambda: torch._weight_int8pack_mm(x, qt, sb)  # noqa
            else:
                # Its layout: [N, K/2] bytes of two consecutive k, then
                # (q - 8) * s + zero' with zero' = (8 - z) * s.
                from aphrodite_tpu_torch.ops import quant_matmul as qm
                q = (args[0] if name == "w4a16_matmul"
                     else qm.unpack_w4(args[0]))
                s, z = args[1], args[2]
                qn = q.t().contiguous().to(torch.uint8)          # [N, K]
                packed = (qn[:, ::2] << 4 | qn[:, 1::2]).contiguous()
                w4 = torch._convert_weight_to_int4pack(packed, 8)
                sz = torch.stack([s, (8.0 - z) * s], dim=-1).to(
                    torch.bfloat16).contiguous()                 # [G, N, 2]
                fn = lambda: torch._weight_int4pack_mm(  # noqa: E731
                    x, w4, 128, sz)
            fn()
            torch.cuda.synchronize()
            return ("int8pack_mm" if name == "w8a16_matmul"
                    else "int4pack_mm"), fn
        except Exception as e:  # the card's torch lacks the op
            log(f"# phase 2: {name}: library op unavailable ({e!r:.120}); "
                "yardstick is torch.matmul on the dequantized weight")
    w = dense.to(x.dtype)
    return "matmul", lambda: torch.matmul(x, w)


def check_quant(gen, name: str, dtype_name: str) -> dict:
    """One quant kernel at its path's four GEMM shapes (M = 32): error
    against the plain version on fp32 copies of the same inputs; times and
    bounds summed over the four GEMMs of a layer. Then errors only at other
    M."""
    import torch
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    dtype = getattr(torch, dtype_name)
    kernel = qm.KERNELS[name]
    M = 32
    tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
               library_ms=0.0, bytes=0.0, ops=0.0)
    lib_label = None
    for gemm, (K, N) in QUANT_KERNELS[name][1].items():
        x, args, plain, dense = quant_inputs(gen, name, K, N, M, dtype)
        out = kernel(x, *args)
        ref = plain(x.float())
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        if not (err <= TOL[dtype_name] and torch.isfinite(out).all()):
            raise AssertionError(f"{name} {gemm} {dtype_name}: max_abs_err "
                                 f"{err} > {TOL[dtype_name]}")
        ms = cuda_ms(lambda: kernel(x, *args), 50)
        t_host = time.perf_counter()
        for _ in range(50):
            kernel(x, *args)
        host_ms = (time.perf_counter() - t_host) * 1e3 / 50
        torch.cuda.synchronize()
        plain_ms = cuda_ms(lambda: plain(x), 3)
        lib_label, lib = library_call(name, x, args, dense)
        lib_ms = cuda_ms(lib, 50)
        nbytes = (x.numel() * x.element_size()
                  + sum(a.numel() * a.element_size() for a in args)
                  + M * N * x.element_size())
        ops = 2.0 * M * K * N
        b_ms, _ = bound_ms(nbytes, ops, dtype_name)
        log(f"# phase 2: {name} {gemm} {dtype_name} M={M} K={K} N={N}: "
            f"err {err:.3g}; kernel {ms:.4f} ms (host {host_ms:.4f} ms a "
            f"call), plain {plain_ms:.4f} ms, "
            f"{lib_label} {lib_ms:.4f} ms, bound {b_ms:.4f} ms")
        for k, v in (("max_abs_err", err), ("ms", ms), ("plain_ms", plain_ms),
                     ("library_ms", lib_ms), ("bytes", nbytes),
                     ("ops", ops)):
            tot[k] = max(tot[k], v) if k == "max_abs_err" else tot[k] + v
    # Other batch sizes (other M tiles and K splits) at the first shape:
    # correctness only.
    K, N = next(iter(QUANT_KERNELS[name][1].values()))
    for M in (1, 5, 13, 40, 200):
        x, args, plain, _ = quant_inputs(gen, name, K, N, M, dtype)
        out = kernel(x, *args)
        err = (out.float() - plain(x.float())).abs().max().item()
        if not (err <= TOL[dtype_name] and torch.isfinite(out).all()):
            raise AssertionError(f"{name} M={M} K={K} N={N} {dtype_name}: "
                                 f"max_abs_err {err} > {TOL[dtype_name]}")
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot.pop("bytes"),
                                                tot.pop("ops"), dtype_name)
    tot["library"] = lib_label
    return tot


def check_prefill_w4(gen) -> None:
    """The W4 prefill product (M > 256) at the 8B wave's shapes (M = 16384,
    packed leaves, bf16): ``quant_gemm.w4a16_matmul``, which dequantizes W
    a slab of groups at a time straight to bf16, against the same product
    through a whole-W fp32 dequantize (``dequant_w4``, then a cast). The
    outputs must be equal; device ms and the peak memory above the inputs
    (output included) over a layer's four GEMMs."""
    import torch
    from aphrodite_tpu_torch.layers.linear import matmul_f32
    from aphrodite_tpu_torch.ops import quant_gemm, quant_matmul as qm
    M = 16384
    ms, peak = {}, {}
    for gemm, (K, N) in LLAMA8B_GEMMS.items():
        x, (p, s, z), _, _ = quant_inputs(gen, "w4a16_packed_matmul", K, N,
                                          M, torch.bfloat16)
        fns = {"slabs": lambda: quant_gemm.w4a16_matmul(x, None, s, z,
                                                        qpacked=p),
               "whole fp32": lambda: matmul_f32(x, qm.dequant_w4(
                   qm.unpack_w4(p), s, z).to(x.dtype)).to(x.dtype)}
        outs = {}
        for label, fn in fns.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            outs[label] = fn()
            torch.cuda.synchronize()
            peak[label] = max(peak.get(label, 0),
                              torch.cuda.max_memory_allocated() - base)
            ms[label] = ms.get(label, 0.0) + cuda_ms(fn, 3)
        if not torch.equal(outs["slabs"], outs["whole fp32"]):
            raise AssertionError(f"W4 prefill product {gemm}: slab-wise "
                                 "dequantize differs from the whole-W one")
        del outs
    log(f"# phase 2: W4 prefill product, 8B wave M={M} bf16, a layer's 4 "
        "GEMMs (equal outputs): " + "; ".join(
            f"{k} dequantize {ms[k]:.4f} ms, peak +{peak[k] / 2**30:.3f} GiB"
            for k in ms))


def group_offsets(gen, M: int, skewed: bool):
    """int32 [E + 1] offsets of M sorted rows over MOE_E experts. Balanced:
    the rows of M / 4 tokens, each routed to 4 distinct random experts.
    Skewed: expert e drawn with weight (e + 1)^-1.5, every sixth expert
    empty (expert 0 takes ~45 % of the rows)."""
    import torch
    if not skewed:
        topi = torch.rand((M // MOE_K, MOE_E), generator=gen,
                          device="cuda").topk(MOE_K, dim=-1).indices
        ids = torch.sort(topi.reshape(-1)).values
    else:
        p = (torch.arange(MOE_E, device="cuda") + 1.0) ** -1.5
        p[torch.arange(MOE_E, device="cuda") % 6 == 5] = 0.0
        ids = torch.sort(torch.multinomial(p, M, replacement=True,
                                           generator=gen)).values
    return torch.searchsorted(ids, torch.arange(MOE_E + 1, device="cuda"),
                              out_int32=True)


def grouped_library(x, w, off, want):
    """(label, fn): one PyTorch call for the same grouped product, which the
    port never calls: ``torch._grouped_mm`` where the card's torch has it
    (and it agrees with the plain version), else a per-expert
    ``torch.matmul`` loop."""
    import torch
    if x.dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        ends = off[1:].contiguous()
        for layout, wl in (("row-major", w), ("column-major", w.transpose(
                1, 2).contiguous().transpose(1, 2))):
            try:
                fn = lambda wl=wl: torch._grouped_mm(x, wl, offs=ends)  # noqa
                err = (fn().float() - want).abs().max().item()
                if err <= TOL["bfloat16"]:
                    return f"_grouped_mm ({layout} w)", fn
                log(f"# phase 2: _grouped_mm ({layout} w) differs by {err}")
            except Exception as e:  # the card's torch refuses this form
                log(f"# phase 2: _grouped_mm ({layout} w) unavailable "
                    f"({e!r:.120})")
    bounds = off.tolist()
    spans = [(e, a, b) for e, (a, b) in enumerate(zip(bounds, bounds[1:]))
             if b > a]
    return "matmul loop", lambda: torch.cat([x[a:b] @ w[e]
                                             for e, a, b in spans])


def check_grouped(gen, dtype_name: str) -> dict:
    """The grouped GEMM at phase 8's shapes (a MoE layer's gate|up and down
    over one prefill wave, M = 65536 rows, 60 experts), balanced and
    skewed, and at M = 240 (the grouped route's threshold, 4 x 60): error
    against the plain version on fp32 copies of the same inputs; times and
    bounds of the balanced wave, summed over the layer's two GEMMs."""
    import torch
    from aphrodite_tpu_torch.ops.grouped_matmul import (grouped_matmul,
                                                        ref_grouped_matmul)
    dtype = getattr(torch, dtype_name)
    item = torch.finfo(dtype).bits // 8
    tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
               bytes=0.0, ops=0.0)
    small = dict(ms=0.0, bytes=0.0, ops=0.0)
    lib_label = None
    for M, case in ((65536, "balanced"), (65536, "skewed"), (240, "balanced"),
                    (240, "skewed")):
        off = group_offsets(gen, M, case == "skewed")
        nonempty = int((off[1:] > off[:-1]).sum())
        for gemm, (K, N) in MOE_GEMMS.items():
            x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((MOE_E, K, N), generator=gen, device="cuda")
                 * (0.5 / K ** 0.5)).to(dtype)
            out = grouped_matmul(x, w, off)
            ref = ref_grouped_matmul(x.float(), w.float(), off)
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            if not (err <= TOL[dtype_name] and torch.isfinite(out).all()):
                raise AssertionError(
                    f"grouped_matmul {gemm} M={M} {case} {dtype_name}: "
                    f"max_abs_err {err} > {TOL[dtype_name]}")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            reps = 50 if M < 4096 else (10 if dtype_name == "bfloat16"
                                        else 3)
            ms = cuda_ms(lambda: grouped_matmul(x, w, off), reps)
            nbytes = item * (M * K + nonempty * K * N + M * N)
            ops = 2.0 * M * K * N
            b_ms, _ = bound_ms(nbytes, ops, dtype_name)
            msg = (f"# phase 2: grouped_matmul {gemm} {dtype_name} M={M} "
                   f"K={K} N={N} {case} ({nonempty} groups): err {err:.3g};"
                   f" kernel {ms:.4f} ms, bound {b_ms:.4f} ms")
            if case == "balanced":
                plain_ms = cuda_ms(lambda: ref_grouped_matmul(x, w, off),
                                   2 if M > 4096 else 5)
                lib_label, lib = grouped_library(x, w, off, ref)
                lib_ms = cuda_ms(lib, reps)
                msg += (f", plain {plain_ms:.4f} ms, {lib_label} "
                        f"{lib_ms:.4f} ms")
                if M == 65536:
                    for k, v in (("ms", ms), ("plain_ms", plain_ms),
                                 ("library_ms", lib_ms), ("bytes", nbytes),
                                 ("ops", ops)):
                        tot[k] += v
                else:
                    for k, v in (("ms", ms), ("bytes", nbytes), ("ops", ops)):
                        small[k] += v
            log(msg)
            del x, w, out, ref
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot.pop("bytes"),
                                                tot.pop("ops"), dtype_name)
    tot["library"] = lib_label
    b_ms, b_by = bound_ms(small["bytes"], small["ops"], dtype_name)
    log(f"# phase 2: grouped_matmul {dtype_name} M=240, a layer's 2 GEMMs: "
        f"kernel {small['ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return tot


def check_scan(gen) -> dict:
    """The selective scan at phase 10's shapes, fp32: a prefill wave (T =
    4096, 8 segments of 512, dA = 0 at each segment's first token) and a
    decode step (T = 32 rows, each its own segment), over a Mamba-2.8B
    layer's 81920 columns, then a ragged edge (T and C not multiples of
    the kernel's 8-row unroll or 128-thread block). The kernel must equal
    its plain version bit for bit. Times and bound of the wave."""
    import torch
    from aphrodite_tpu_torch.ops.selective_scan import (ref_selective_scan,
                                                        selective_scan)
    res = {}
    for label, T, C, seg in (("wave", 4096, SCAN_COLUMNS, 512),
                             ("decode", 32, SCAN_COLUMNS, 1),
                             ("ragged", 4101, 1003, 700)):
        dA = 0.5 + 0.5 * torch.rand((T, C), generator=gen, device="cuda")
        dA[::seg] = 0.0
        dBx = torch.randn((T, C), generator=gen, device="cuda")
        out = selective_scan(dA, dBx)
        ref = ref_selective_scan(dA, dBx)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not (torch.equal(out, ref) and torch.isfinite(out).all()):
            raise AssertionError(f"selective_scan {label} T={T} C={C}: "
                                 f"differs from its plain version by {err}")
        ms = cuda_ms(lambda: selective_scan(dA, dBx), 20)
        plain_ms = cuda_ms(lambda: ref_selective_scan(dA, dBx), 1)
        b_ms, b_by = bound_ms(12.0 * T * C, 2.0 * T * C, "float32")
        log(f"# phase 2: selective_scan {label} fp32 T={T} C={C}: equal to "
            f"the plain version; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{12.0 * T * C / ms / 1e6:.0f} GB/s")
        res[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del dA, dBx, out, ref
    return res["wave"]


def tiny_parity() -> None:
    """fp32 greedy tokens through the port on the card and on the CPU, with
    the same weights, across chunked prefill and decode windows."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
               num_attention_heads=8, num_key_value_heads=2,
               intermediate_size=256, max_position_embeddings=1024,
               tie_word_embeddings=False, architectures=["Qwen2ForCausalLM"])
    kw = dict(hf_config=cfg, tokenizer="unused", dtype="float32",
              block_size=64, num_kv_blocks=64, max_num_seqs=4,
              max_num_batched_tokens=96, max_model_len=512)
    cpu = LLM("tiny", device="cpu", **kw)
    gpu = LLM("tiny", device="cuda", **kw)
    state = {k: v.numpy() for k, v in
             cpu.engine.core.worker.model.state_dict().items()}
    gpu.engine.core.worker.load_params(state)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 500, size=n).tolist()
               for n in (7, 150, 64, 90, 33)]
    params = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
    a = [o.outputs[0].token_ids for o in cpu.generate(prompts, params)]
    b = [o.outputs[0].token_ids for o in gpu.generate(prompts, params)]
    if a != b:
        raise AssertionError(f"cuda vs cpu greedy tokens differ:\n{a}\n{b}")
    log(f"# phase 3: cuda == cpu greedy tokens for {len(prompts)} prompts "
        f"x 24 (chunked prefill + decode windows)")


def main_path() -> dict:
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)
    from aphrodite_tpu_torch.ops.window_decode_attention import (
        window_decode_attention)
    num_prompts, prefix_len, decode_len = 64, 500, 50
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM("qwen2.5-1.5b-dummy", hf_config=QWEN25_1P5B,
              tokenizer="unused", dtype="bfloat16", load_format="dummy",
              block_size=64, max_num_batched_tokens=16384, max_num_seqs=32,
              max_model_len=prefix_len + decode_len + 64, device="cuda")
    torch.cuda.synchronize()
    log(f"# phase 4: engine init {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(10, 1000, size=prefix_len).tolist()
               for _ in range(num_prompts)]
    params = SamplingParams(temperature=0.0, max_tokens=decode_len,
                            ignore_eos=True)

    def one_run() -> float:
        t = time.perf_counter()
        outs = llm.generate(prompts, params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        toks = [o.outputs[0].token_ids for o in outs]
        n = sum(len(x) for x in toks)
        if n != num_prompts * decode_len:
            raise AssertionError(f"expected {num_prompts * decode_len} "
                                 f"tokens, got {n}")
        if not all(0 <= t < QWEN25_1P5B["vocab_size"] for x in toks
                   for t in x):
            raise AssertionError("token id out of the vocabulary")
        return dt

    log(f"# phase 4: warm-up run {one_run():.3f} s")
    times, counts = [], {}
    for i in range(3):
        ragged_paged_attention.launches = 0
        window_decode_attention.launches = 0
        times.append(one_run())
        counts = {"ragged_paged_attention": ragged_paged_attention.launches,
                  "window_decode_attention": window_decode_attention.launches}
        log(f"# phase 4: run {i}: {times[-1]:.3f} s, launches {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {counts}")
    s = float(np.mean(times))
    log(f"# phase 4: {s:.3f} s/run (runs {times}); "
        f"{num_prompts * decode_len / s:.0f} decode tok/s; "
        f"{num_prompts * (prefix_len + decode_len) / s:.0f} tok/s "
        f"(prefill+decode); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_run(one_run)
    return counts


QWEN_2L = dict(QWEN25_1P5B, num_hidden_layers=2)


def quant_parity() -> dict:
    """fp32 greedy tokens through the port on the card and on the CPU with
    the same quantized weights, at Qwen2.5-1.5B widths (K 1536 and 8960:
    no W4 leaf packs) and 2 layers. Returns each kernel's launches on the
    card run."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 150000, size=n).tolist()
               for n in (7, 150, 64, 90, 33)]
    params = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
    launches = {}
    for quant, kernel in (("gptq", "w4a16_matmul"),
                          ("w8a16", "w8a16_matmul")):
        kw = dict(hf_config=QWEN_2L, tokenizer="unused", dtype="float32",
                  quantization=quant, block_size=64, num_kv_blocks=64,
                  max_num_seqs=4, max_num_batched_tokens=96,
                  max_model_len=512)
        cpu = LLM("qwen-2l", device="cpu", **kw)
        gpu = LLM("qwen-2l", device="cuda", **kw)
        state = {k: v.numpy() for k, v in
                 cpu.engine.core.worker.model.state_dict().items()}
        gpu.engine.core.worker.load_params(state)
        a = [o.outputs[0].token_ids for o in cpu.generate(prompts, params)]
        for fn in qm.KERNELS.values():
            fn.launches = 0
        b = [o.outputs[0].token_ids for o in gpu.generate(prompts, params)]
        launches[kernel] = qm.KERNELS[kernel].launches
        if a != b:
            raise AssertionError(f"{quant}: cuda vs cpu greedy tokens "
                                 f"differ:\n{a}\n{b}")
        if launches[kernel] <= 0:
            raise AssertionError(f"{quant}: {kernel} was not launched")
        log(f"# phase 5: {quant}: cuda == cpu greedy tokens for "
            f"{len(prompts)} prompts x 24; {kernel} launches "
            f"{launches[kernel]}")
        del cpu, gpu
    return launches


def moe_parity() -> int:
    """fp32 greedy tokens through the port on the card and on the CPU with
    the same weights for a tiny Qwen2-MoE: 8 experts, top-2, a gated
    shared expert, layer 1 dense. Waves of up to 96 tokens take the
    grouped route (T * 2 >= 32), decode windows the dense one. Returns the
    grouped GEMM's launches on the card run."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.grouped_matmul import grouped_matmul
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(vocab_size=512, hidden_size=128, num_hidden_layers=3,
               num_attention_heads=8, num_key_value_heads=2,
               intermediate_size=256, moe_intermediate_size=72,
               shared_expert_intermediate_size=136, num_experts=8,
               num_experts_per_tok=2, norm_topk_prob=False,
               mlp_only_layers=[1], max_position_embeddings=1024,
               use_sliding_window=False, tie_word_embeddings=False,
               architectures=["Qwen2MoeForCausalLM"])
    kw = dict(hf_config=cfg, tokenizer="unused", dtype="float32",
              block_size=64, num_kv_blocks=64, max_num_seqs=4,
              max_num_batched_tokens=96, max_model_len=512)
    cpu = LLM("tiny-moe", device="cpu", **kw)
    gpu = LLM("tiny-moe", device="cuda", **kw)
    state = {k: v.numpy() for k, v in
             cpu.engine.core.worker.model.state_dict().items()}
    gpu.engine.core.worker.load_params(state)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 500, size=n).tolist()
               for n in (7, 150, 64, 90, 33)]
    params = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
    a = [o.outputs[0].token_ids for o in cpu.generate(prompts, params)]
    grouped_matmul.launches = 0
    b = [o.outputs[0].token_ids for o in gpu.generate(prompts, params)]
    launches = grouped_matmul.launches
    if a != b:
        raise AssertionError(f"MoE: cuda vs cpu greedy tokens differ:\n{a}"
                             f"\n{b}")
    if launches <= 0:
        raise AssertionError("MoE: grouped_matmul was not launched")
    log(f"# phase 7: cuda == cpu greedy tokens for {len(prompts)} prompts "
        f"x 24 (tiny Qwen2-MoE); grouped_matmul launches {launches}")
    return launches


def serve_workload(phase: str, name: str, hf: dict, counted: dict,
                   batch_tokens: int = 16384,
                   per_forward: dict | None = None,
                   exact: dict | None = None, **llm_kw):
    """32 prompts x (512 + 64) greedy through ``LLM.generate`` at full
    width: one warm-up, 3 cold runs (prefix cache reset before each), 3
    warm runs (only where the engine caches prefixes; where it does not,
    every run must find no cached prompt token), one profiled run. Each
    run must give exactly 2048 tokens in the vocabulary; every kernel in
    ``counted`` must have
    launched in the cold runs, and every kernel in ``per_forward`` exactly
    that many times for each call of the model's ``forward`` in every cold
    run; every kernel in ``exact`` exactly that many times in every cold and
    warm run (0: never). Returns the last cold run's launches and the
    engine."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    num_prompts, prompt_len, decode_len = 32, 512, 64
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"# {phase}: allocated before init "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    llm = LLM(name, hf_config=hf, tokenizer="unused", dtype="bfloat16",
              load_format="dummy", block_size=64, max_num_seqs=32,
              max_num_batched_tokens=batch_tokens, max_model_len=704,
              device="cuda", **llm_kw)
    torch.cuda.synchronize()
    log(f"# {phase}: engine init {time.perf_counter() - t0:.2f} s, weights "
        f"+ KV {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prefix_cache = llm.engine.config.cache_config.enable_prefix_caching
    model = llm.engine.core.worker.model
    forward = model.forward
    forwards = [0]

    def counted_forward(*a, **kw):
        forwards[0] += 1
        return forward(*a, **kw)
    model.forward = counted_forward
    rng = np.random.RandomState(0)
    top = min(100000, hf["vocab_size"] - 10)
    prompts = [rng.randint(10, top, size=prompt_len).tolist()
               for _ in range(num_prompts)]
    params = SamplingParams(temperature=0.0, max_tokens=decode_len,
                            ignore_eos=True)

    def check_exact(got: dict) -> None:
        for k, want in (exact or {}).items():
            if got[k] != want:
                raise AssertionError(f"{k}: {got[k]} launches in a run, "
                                     f"want {want}")

    def one_run() -> float:
        for fn in counted.values():
            fn.launches = 0
        forwards[0] = 0
        t = time.perf_counter()
        outs = llm.generate(prompts, params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        toks = [o.outputs[0].token_ids for o in outs]
        n = sum(len(x) for x in toks)
        if n != num_prompts * decode_len:
            raise AssertionError(f"expected {num_prompts * decode_len} "
                                 f"tokens, got {n}")
        if not all(0 <= t < hf["vocab_size"] for x in toks for t in x):
            raise AssertionError("token id out of the vocabulary")
        one_run.cached = sum(o.num_cached_tokens for o in outs)
        return dt

    log(f"# {phase}: warm-up run {one_run():.3f} s")
    cold, warm, counts = [], [], {}
    for i in range(3):
        if not llm.engine.reset_prefix_cache():
            raise AssertionError("reset_prefix_cache refused")
        cold.append(one_run())
        counts = {k: fn.launches for k, fn in counted.items()}
        log(f"# {phase}: cold run {i}: {cold[-1]:.3f} s, cached prompt "
            f"tokens {one_run.cached}, launches {counts}, model forwards "
            f"{forwards[0]}")
        for k, per in (per_forward or {}).items():
            if counts[k] != per * forwards[0]:
                raise AssertionError(f"{k}: {counts[k]} launches for "
                                     f"{forwards[0]} forwards, want {per} "
                                     "each")
        if not prefix_cache and one_run.cached:
            raise AssertionError(f"{one_run.cached} cached prompt tokens "
                                 "with prefix caching off")
        check_exact(counts)
    if any(v <= 0 for k, v in counts.items() if k not in (exact or {})):
        raise AssertionError(f"a kernel was not launched: {counts}")
    for i in range(3 if prefix_cache else 0):
        warm.append(one_run())
        wc = {k: fn.launches for k, fn in counted.items()}
        log(f"# {phase}: warm run {i}: {warm[-1]:.3f} s, cached prompt "
            f"tokens {one_run.cached}, launches {wc}")
        check_exact(wc)
    n_dec = num_prompts * decode_len
    n_all = num_prompts * (prompt_len + decode_len)
    for label, ts in (("cold", cold), ("warm", warm)):
        if not ts:
            continue
        s = float(np.mean(ts))
        log(f"# {phase}: {label} {s:.3f} s/run (runs {ts}); "
            f"{n_dec / s:.0f} decode tok/s; {n_all / s:.0f} tok/s "
            "(prefill+decode)")
    log(f"# {phase}: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    llm.engine.reset_prefix_cache()
    profile_run(one_run, phase)
    return counts, llm


def attention_kernels() -> dict:
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)
    from aphrodite_tpu_torch.ops.window_decode_attention import (
        window_decode_attention)
    return {"ragged_paged_attention": ragged_paged_attention,
            "window_decode_attention": window_decode_attention}


def main_path_8b() -> dict:
    """Llama-3.1-8B W4A16 at full width: the repo's BASELINE config 2
    workload (benchmarks/baseline_configs.py:118-128) through the port."""
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    return serve_workload(
        "phase 6", "llama-3.1-8b-w4a16-dummy", LLAMA31_8B,
        {"w4a16_packed_matmul": qm.w4a16_packed_matmul,
         **attention_kernels()}, quantization="gptq")[0]


def main_path_moe() -> dict:
    """Qwen1.5-MoE-A2.7B bf16 at full width and depth, the same traffic:
    one prefill wave (65536 sorted rows a MoE layer: the grouped GEMM),
    then a 63-step decode window (32 rows: the dense expert combine)."""
    from aphrodite_tpu_torch.ops.grouped_matmul import grouped_matmul
    return serve_workload(
        "phase 8", "qwen1.5-moe-a2.7b-dummy", QWEN15_MOE_A27B,
        {"grouped_matmul": grouped_matmul, **attention_kernels()})[0]


SSM_TINY = {  # tiny geometries of the three SSM families
    "MambaForCausalLM": dict(
        model_type="mamba", intermediate_size=128, time_step_rank=8,
        use_conv_bias=True, use_bias=True),
    "FalconMambaForCausalLM": dict(
        model_type="falcon_mamba", intermediate_size=128, time_step_rank=8,
        mixer_rms_eps=1e-6),
    "Mamba2ForCausalLM": dict(
        model_type="mamba2", expand=2, head_dim=16, num_heads=8, n_groups=2),
}


def redraw_at_fan_in(model, seed: int) -> None:
    """Weights at fan-in scale from a seeded CPU generator (the dummy
    recipe's 0.02 and zero biases make a near-identity model whose greedy
    tokens hardly depend on the state)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("dt_b", "dt_bias"):
                new = -1.0 - 2.0 * torch.rand(p.shape, generator=g)
            elif leaf == "A_log":
                new = p.float() + 0.1 * torch.randn(p.shape, generator=g)
            elif leaf == "conv_w":
                new = 0.5 * torch.randn(p.shape, generator=g)
            elif leaf.endswith("_b"):
                new = 0.1 * torch.randn(p.shape, generator=g)
            elif p.dim() == 2:  # [fan_in, fan_out] projections, embed
                new = torch.randn(p.shape, generator=g) / p.shape[0] ** 0.5
            else:  # norms, D
                new = 1.0 + 0.1 * torch.randn(p.shape, generator=g)
            p.copy_(new.to(p.dtype))


def ssm_parity() -> None:
    """fp32 greedy tokens through the port on the card and on the CPU with
    the same weights for a tiny Mamba, FalconMamba and Mamba-2: chunked
    prefill at a 16-token budget (state carried across the seams), ragged
    max_tokens (frozen rows in decode windows)."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.selective_scan import selective_scan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 250, size=n).tolist()
               for n in (5, 40, 17, 33, 2, 21)]
    params = [SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True)
              for n in (24, 9, 17, 24, 3, 12)]
    for arch, geom in SSM_TINY.items():
        cfg = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                   state_size=8, conv_kernel=4, tie_word_embeddings=False,
                   architectures=[arch], **geom)
        kw = dict(hf_config=cfg, tokenizer="unused", dtype="float32",
                  block_size=16, max_num_seqs=4, max_num_batched_tokens=16,
                  max_model_len=256)
        cpu = LLM("tiny-ssm", device="cpu", **kw)
        redraw_at_fan_in(cpu.engine.core.worker.model, 5)
        gpu = LLM("tiny-ssm", device="cuda", **kw)
        state = {k: v.numpy() for k, v in
                 cpu.engine.core.worker.model.state_dict().items()}
        gpu.engine.core.worker.load_params(state)
        a = [o.outputs[0].token_ids for o in cpu.generate(prompts, params)]
        selective_scan.launches = 0
        b = [o.outputs[0].token_ids for o in gpu.generate(prompts, params)]
        if a != b:
            raise AssertionError(f"{arch}: cuda vs cpu greedy tokens "
                                 f"differ:\n{a}\n{b}")
        if selective_scan.launches <= 0:
            raise AssertionError(f"{arch}: selective_scan was not launched")
        log(f"# phase 9: {arch}: cuda == cpu greedy tokens for "
            f"{len(prompts)} prompts (16-token chunks, ragged max_tokens); "
            f"selective_scan launches {selective_scan.launches}")
        del cpu, gpu


def main_path_mamba() -> dict:
    """Mamba-2.8B bf16 at full width and depth, phase 6's traffic at the
    JAX SSM bench's 4096-token budget (benchmarks/ssm_bench.py:52):
    prefill waves of up to 4096 tokens (each [4096, 5120, 16] fp32 scan
    input 1.34 GB), then a decode window of 32 one-token rows. The scan must run
    once a layer in every forward of the runner."""
    from aphrodite_tpu_torch.ops.selective_scan import selective_scan
    return serve_workload(
        "phase 10", "mamba-2.8b-dummy", MAMBA_2P8B,
        {"selective_scan": selective_scan}, batch_tokens=4096,
        per_forward={"selective_scan": MAMBA_2P8B["num_hidden_layers"]})[0]


GEMMA2_9B = dict(  # google/gemma-2-9b config.json
    vocab_size=256000, hidden_size=3584, num_hidden_layers=42,
    num_attention_heads=16, num_key_value_heads=8, head_dim=256,
    intermediate_size=14336, hidden_act="gelu_pytorch_tanh",
    hidden_activation="gelu_pytorch_tanh", rms_norm_eps=1e-6,
    rope_theta=10000.0, query_pre_attn_scalar=256,
    attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
    sliding_window=4096, max_position_embeddings=8192,
    tie_word_embeddings=True, model_type="gemma2",
    architectures=["Gemma2ForCausalLM"])

GEMMA_TINY = {  # phase 11: tiny Gemma-2 (head_dim 256) and Gemma-3 (MQA)
    "Gemma2ForCausalLM": dict(
        num_attention_heads=4, num_key_value_heads=2, head_dim=256,
        model_type="gemma2"),
    "Gemma3ForCausalLM": dict(
        num_attention_heads=4, num_key_value_heads=1, head_dim=128,
        rope_theta=1000000.0, rope_local_base_freq=10000.0,
        rope_scaling={"rope_type": "linear", "factor": 8.0},
        layer_types=["sliding_attention", "sliding_attention",
                     "full_attention"], model_type="gemma3_text"),
}


def redraw_gemma(model, seed: int) -> None:
    """Weights at fan-in scale from a seeded CPU generator, norms (stored
    as w - 1) near 0 and the embedding 4x smaller than fan-in scale: with
    the dummy recipe, and with a fan-in scale embedding that the sqrt(H)
    input scale makes dominate, Gemma repeats its input token."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                new = 0.1 * torch.randn(p.shape, generator=g)
            elif name == "embed":
                new = torch.randn(p.shape, generator=g) / (4 * p.shape[1]
                                                           ** 0.5)
            else:  # [fan_in, fan_out] projections
                new = torch.randn(p.shape, generator=g) / p.shape[0] ** 0.5
            p.copy_(new.to(p.dtype))


def gemma_parity() -> int:
    """fp32 greedy tokens through the port on the card and on the CPU with
    the same weights for a tiny Gemma-2 and Gemma-3: a 16-token sliding
    window, attention and final soft caps, prompts past the window, 16-step
    decode windows on the decode kernel. Returns the decode kernel's
    launches on the card runs."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.decode_paged_attention import (
        decode_paged_attention)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 250, size=n).tolist()
               for n in (5, 40, 17, 33, 70)]
    params = [SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True)
              for n in (24, 9, 30, 17, 24)]
    total = 0
    for arch, geom in GEMMA_TINY.items():
        cfg = dict(vocab_size=256, hidden_size=64, num_hidden_layers=3,
                   intermediate_size=128, sliding_window=16,
                   query_pre_attn_scalar=24, attn_logit_softcapping=50.0,
                   final_logit_softcapping=30.0, max_position_embeddings=512,
                   architectures=[arch], **geom)
        kw = dict(hf_config=cfg, tokenizer="unused", dtype="float32",
                  block_size=16, num_kv_blocks=128, max_num_seqs=4,
                  max_num_batched_tokens=32, max_model_len=256,
                  decode_window=16)
        cpu = LLM("tiny-gemma", device="cpu", **kw)
        redraw_gemma(cpu.engine.core.worker.model, 6)
        gpu = LLM("tiny-gemma", device="cuda", **kw)
        state = {k: v.numpy() for k, v in
                 cpu.engine.core.worker.model.state_dict().items()}
        gpu.engine.core.worker.load_params(state)
        a = [o.outputs[0].token_ids for o in cpu.generate(prompts, params)]
        decode_paged_attention.launches = 0
        b = [o.outputs[0].token_ids for o in gpu.generate(prompts, params)]
        if a != b:
            raise AssertionError(f"{arch}: cuda vs cpu greedy tokens "
                                 f"differ:\n{a}\n{b}")
        if decode_paged_attention.launches <= 0:
            raise AssertionError(f"{arch}: decode_paged_attention was not "
                                 "launched")
        if len({t for x in a for t in x}) <= 10:
            raise AssertionError(f"{arch}: the tokens hardly vary: {a}")
        total += decode_paged_attention.launches
        log(f"# phase 11: {arch}: cuda == cpu greedy tokens for "
            f"{len(prompts)} prompts (window 16, soft caps, 16-step decode "
            f"windows); decode_paged_attention launches "
            f"{decode_paged_attention.launches}")
        del cpu, gpu
    return total


def main_path_gemma() -> dict:
    """Gemma-2-9B bf16 at full width and depth, phase 6's traffic: one
    16384-token prefill wave (the ragged kernel, 80-row items at head_dim
    256), then one 63-step decode window through the runner's non-window
    multi-step path: the decode kernel once a layer a sub-step, 42 x 63 =
    2646 launches a run, and the window kernel never."""
    from aphrodite_tpu_torch.ops.decode_paged_attention import (
        decode_paged_attention)
    L = GEMMA2_9B["num_hidden_layers"]
    kernels = {"decode_paged_attention": decode_paged_attention,
               **attention_kernels()}
    return serve_workload(
        "phase 12", "gemma-2-9b-dummy", GEMMA2_9B, kernels,
        exact={"decode_paged_attention": L * 63,
               "ragged_paged_attention": L,
               "window_decode_attention": 0})[0]


def profile_run(one_run, phase: str = "phase 4") -> None:
    """One more run under torch.profiler: device busy share of the wall
    time and device time by kernel family."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = one_run()
    t0 = time.perf_counter()
    # The raw events, read once: key_averages() would build a tree over
    # every host op of the run (minutes for a Mamba run). A device event's
    # linked_correlation_id is the correlation_id of the host op that
    # launched it, as key_averages() itself pairs them.
    kernels: dict[str, list] = {}  # name -> [device ns, launches]
    links: dict[int, int] = {}     # host op correlation id -> device ns
    host_ops, bmm_spans = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ns = e.end_ns() - e.start_ns()
            k = kernels.setdefault(e.name(), [0, 0])
            k[0] += ns
            k[1] += 1
            c = e.linked_correlation_id()
            links[c] = links.get(c, 0) + ns
        elif e.linked_correlation_id() == 0:
            host_ops.append(e)
            if e.name() == "aten::bmm":
                bmm_spans.setdefault(e.start_thread_id(), []).append(
                    (e.start_ns(), e.end_ns()))
    fam = {"ragged": 0.0, "window": 0.0, "decode": 0.0, "quant": 0.0,
           "moe": 0.0, "scan": 0.0, "gemm": 0.0, "other": 0.0}
    for name, (ns, _) in kernels.items():
        n = name.lower()
        k = ("ragged" if "rpa_kernel" in n else
             "window" if "wd_kernel" in n else
             "decode" if "dpa_kernel" in n else
             "quant" if "qmm_" in n else
             "moe" if "gmm_" in n else
             "scan" if "scan_kernel" in n else
             "gemm" if any(s in n for s in ("gemm", "cutlass", "sm90_xmma",
                                            "gemv", "nvjet")) else "other")
        fam[k] += ns / 1e9
    busy = sum(fam.values())
    # Device time under aten::bmm, its child ops included: the MoE dense
    # (decode) expert combine's batched products (phase 8) or the Mamba
    # hs . C contraction (phase 10), the only bmm of the port's forwards.
    for spans in bmm_spans.values():
        spans.sort()
    bmm = 0
    for e in host_ops:
        spans = bmm_spans.get(e.start_thread_id())
        if spans:
            i = bisect.bisect_right(spans, (e.start_ns(), math.inf)) - 1
            if i >= 0 and e.start_ns() <= spans[i][1]:
                bmm += links.get(e.correlation_id(), 0)
    log(f"# {phase} profile: wall {wall:.3f} s (profiled), device busy "
        f"{busy:.3f} s ({busy / wall:.1%}); " + ", ".join(
            f"{k} {v:.3f} s" for k, v in fam.items())
        + f"; of which aten::bmm {bmm / 1e9:.3f} s; trace read in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (ns, count) in sorted(kernels.items(),
                                    key=lambda kv: -kv[1][0])[:8]:
        log(f"# {phase} profile: {ns / 1e6:9.1f} ms x{count:<6d} "
            f"{name[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from aphrodite_tpu_torch.ops import cuda_build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"# card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    names = ["ragged_paged_attention", "window_decode_attention",
             "decode_paged_attention", "quant_matmul", "grouped_matmul",
             "selective_scan"]
    log(f"# phase 1: kernels built in {cuda_build.build_all(names):.1f} s")
    for n in names:
        for line in cuda_build.ptxas_report(n).splitlines():
            if "entry function" in line:  # keep the template arguments
                log(f"# ptxas {n}: ...{line.strip()[-72:]}")
            elif "registers" in line or "spill" in line:
                log(f"# ptxas {n}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dt in ("float32", "bfloat16"):
        for path, geom in ATTN_GEOMS.items():
            for name, fn in (("ragged_paged_attention", check_ragged),
                             ("window_decode_attention", check_window)):
                r = fn(gen, dt, geom)
                log(f"# phase 2: {name} {dt} at {path} shapes: max_abs_err "
                    f"{r['max_abs_err']:.3g} (tol {TOL[dt]}); kernel "
                    f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
                    f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']})")
                results[(name, path, dt)] = r
        for name in QUANT_KERNELS:
            r = check_quant(gen, name, dt)
            log(f"# phase 2: {name} {dt}, a layer's 4 GEMMs: max_abs_err"
                f" {r['max_abs_err']:.3g} (tol {TOL[dt]}); kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"{r['library']} {r['library_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
            results[(name, dt)] = r
        for case in DECODE_CASES:
            results[("decode_paged_attention", case, dt)] = check_decode(
                gen, dt, case)
        r = check_grouped(gen, dt)
        log(f"# phase 2: grouped_matmul {dt}, a MoE layer's 2 GEMMs over a "
            f"wave (M=65536, balanced): max_abs_err {r['max_abs_err']:.3g} "
            f"(tol {TOL[dt]}, all cases); kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, {r['library']} {r['library_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        results[("grouped_matmul", dt)] = r
    r = check_scan(gen)
    log(f"# phase 2: selective_scan fp32 at the Mamba-2.8B wave (T=4096, "
        f"C={SCAN_COLUMNS}): max_abs_err {r['max_abs_err']:.3g} (must be "
        f"0); kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}); no library call")
    results[("selective_scan", "float32")] = r
    check_prefill_w4(gen)
    tiny_parity()
    qwen_counts = main_path()
    log(f"# phase 4: attention launches per run {qwen_counts}")
    quant_counts = quant_parity()
    llama_counts = main_path_8b()
    moe_parity()
    moe_counts = main_path_moe()
    ssm_parity()
    mamba_counts = main_path_mamba()
    gemma_parity()
    gemma_counts = main_path_gemma()

    # One row per kernel and path that runs it: that path's launches, and
    # times and errors at its shapes and activation dtype.
    rows = [(name, path, "bfloat16", counts[name], results[(name, path,
                                                             "bfloat16")])
            for path, counts in (("qwen2.5-1.5b-bf16", qwen_counts),
                                 ("llama-3.1-8b-w4a16", llama_counts),
                                 ("qwen1.5-moe-a2.7b-bf16", moe_counts))
            for name in ("ragged_paged_attention", "window_decode_attention")]
    rows.append(("ragged_paged_attention", "gemma-2-9b-bf16", "bfloat16",
                 gemma_counts["ragged_paged_attention"],
                 results[("ragged_paged_attention", "gemma-2-9b-bf16",
                          "bfloat16")]))
    rows.append(("decode_paged_attention", "gemma-2-9b-bf16", "bfloat16",
                 gemma_counts["decode_paged_attention"],
                 results[("decode_paged_attention", "gemma-2-9b",
                          "bfloat16")]))
    rows.append(("w4a16_packed_matmul", "llama-3.1-8b-w4a16", "bfloat16",
                 llama_counts["w4a16_packed_matmul"],
                 results[("w4a16_packed_matmul", "bfloat16")]))
    rows.append(("grouped_matmul", "qwen1.5-moe-a2.7b-bf16", "bfloat16",
                 moe_counts["grouped_matmul"],
                 results[("grouped_matmul", "bfloat16")]))
    rows += [(name, "qwen-2l-quant-parity-fp32", "float32",
              quant_counts[name], results[(name, "float32")])
             for name in ("w4a16_matmul", "w8a16_matmul")]
    rows.append(("selective_scan", "mamba-2.8b-bf16", "float32",
                 mamba_counts["selective_scan"],
                 results[("selective_scan", "float32")]))
    replaces = {"ragged_paged_attention":
                "aphrodite_tpu/ops/ragged_paged_attention.py:247",
                "window_decode_attention":
                "aphrodite_tpu/ops/window_decode_attention.py:198",
                "decode_paged_attention":
                "aphrodite_tpu/ops/decode_paged_attention.py:138",
                # megablox gmm (jax/experimental/pallas/ops/tpu/megablox/
                # gmm.py:314), called here:
                "grouped_matmul": "aphrodite_tpu/models/moe_common.py:208",
                "selective_scan": "aphrodite_tpu/ops/selective_scan.py:64",
                **{n: r for n, (r, _) in QUANT_KERNELS.items()}}
    kernels = []
    for name, path, dt, launches, r in rows:
        src = "quant_matmul" if name in QUANT_KERNELS else name
        kernels.append({
            "name": name, "path": path, "dtype": dt, "route": "cuda",
            "source": f"aphrodite_tpu_torch/csrc/{src}.cu",
            "replaces": replaces[name], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
