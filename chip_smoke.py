#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``aphrodite_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and nothing of JAX. Phases, each fatal on failure:

1. Print the card's name and power limit; build the CUDA kernels from
   ``aphrodite_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel).
2. Hold each kernel against its plain PyTorch version at the main path's
   shapes, in bf16 and fp32, and time kernel, plain version and a library
   yardstick (``scaled_dot_product_attention`` over gathered dense K/V,
   which the port itself never calls).
3. Run a tiny model end to end in fp32 through the port's ``LLM`` on the
   card and on the CPU with the same weights: greedy tokens must be equal.
4. The main path: Qwen2.5-1.5B geometry, bf16 dummy weights, block 64,
   max_num_seqs 32, 64 prompts x (500 + 50) greedy through ``LLM.generate``;
   one warm-up run, then timed runs. Exactly 3200 tokens must come out and
   both kernels must have been launched.

The last lines are the kernels' JSON record, the card line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM (NVIDIA data sheet)
PEAK_OPS = {"bfloat16": 989e12,  # dense bf16 tensor cores
            "float32": 67e12}    # fp32 outside the tensor cores
PAGE, NQ, KVH, HD = 64, 12, 2, 128
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max-abs, outputs are O(1)

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


def paged_cache(gen, ctx_lens, dtype, num_layers=2):
    """Random [L, P, 2, kvh, page, hd] cache and shuffled block tables
    covering ctx_lens tokens per request."""
    import torch
    pages_per = [-(-n // PAGE) for n in ctx_lens]
    max_pages = max(pages_per)
    num_pages = sum(pages_per) + 1
    cache = torch.randn((num_layers, num_pages, 2, KVH, PAGE, HD),
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
    R = len(ctx_lens)
    kv = cache_layer[bt.long()]                 # [R, MP, 2, kvh, page, hd]
    kv = kv.permute(0, 2, 3, 1, 4, 5).reshape(R, 2, KVH, -1, HD)
    return kv[:, 0, :, :s_max].contiguous(), kv[:, 1, :, :s_max].contiguous()


def check_ragged(gen, dtype_name: str) -> dict:
    """Kernel A on one prefill/mixed wave: 28 prompts of 500 tokens plus
    4 decode rows at context ~530 (32 requests, as the main path's wave)."""
    import torch
    import torch.nn.functional as F
    from aphrodite_tpu_torch.attention.metadata import (AttentionMetadata,
                                                        build_work_items)
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention, ref_ragged_paged_attention)
    dtype = getattr(torch, dtype_name)
    ctx = [500] * 28 + [521, 527, 533, 540]
    qn = [500] * 28 + [1, 1, 1, 1]
    cache, bt = paged_cache(gen, ctx, dtype)
    R, T = len(ctx), sum(qn)
    qsl = np.concatenate([[0], np.cumsum(qn)]).astype(np.int32)
    tok_req = np.repeat(np.arange(R), qn).astype(np.int32)
    tok_pos = np.concatenate([np.arange(c - n, c) for c, n in zip(ctx, qn)])
    block_q = 128 // (NQ // KVH)
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
    # [R, nq, 500, hd] batch with a [R, 1, 500, S] mask.
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


def check_window(gen, dtype_name: str) -> dict:
    """Kernel B on one decode sub-step: 32 requests at paged lengths
    500-550 with a 64-slot tail, at several window steps."""
    import torch
    import torch.nn.functional as F
    from aphrodite_tpu_torch.ops.window_decode_attention import (
        ref_window_decode_attention, window_decode_attention)
    dtype = getattr(torch, dtype_name)
    R, Kw, layer = 32, 64, 1
    plens = [500 + (37 * r) % 51 for r in range(R)]
    cache, bt = paged_cache(gen, [p + Kw for p in plens], dtype)
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


def profile_run(one_run) -> None:
    """One more run under torch.profiler: device busy share of the wall
    time and device time by kernel family."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = one_run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    fam = {"ragged": 0.0, "window": 0.0, "gemm": 0.0, "other": 0.0}
    for e in kernels:
        n = e.key.lower()
        k = ("ragged" if "rpa_kernel" in n else
             "window" if "wd_kernel" in n else
             "gemm" if any(s in n for s in ("gemm", "cutlass", "sm90_xmma",
                                            "gemv", "nvjet")) else "other")
        fam[k] += e.self_device_time_total / 1e6
    busy = sum(fam.values())
    log(f"# phase 4 profile: wall {wall:.3f} s (profiled), device busy "
        f"{busy:.3f} s ({busy / wall:.1%}); " + ", ".join(
            f"{k} {v:.3f} s" for k, v in fam.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"# phase 4 profile: {e.self_device_time_total / 1e3:9.1f} ms "
            f"x{e.count:<6d} {e.key[:90]}")


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
    names = ["ragged_paged_attention", "window_decode_attention"]
    log(f"# phase 1: kernels built in {cuda_build.build_all(names):.1f} s")
    for n in names:
        for line in cuda_build.ptxas_report(n).splitlines():
            if "registers" in line or "spill" in line:
                log(f"# ptxas {n}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dt in ("float32", "bfloat16"):
        for name, fn in (("ragged_paged_attention", check_ragged),
                         ("window_decode_attention", check_window)):
            r = fn(gen, dt)
            log(f"# phase 2: {name} {dt}: max_abs_err {r['max_abs_err']:.3g}"
                f" (tol {TOL[dt]}); kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
            results[(name, dt)] = r

    tiny_parity()
    counts = main_path()

    kernels = []
    for name, replaces in (
            ("ragged_paged_attention",
             "aphrodite_tpu/ops/ragged_paged_attention.py:247"),
            ("window_decode_attention",
             "aphrodite_tpu/ops/window_decode_attention.py:198")):
        r = results[(name, "bfloat16")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"aphrodite_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": counts[name],
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
