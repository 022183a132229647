#!/usr/bin/env python3
"""Time variants of the bf16 grouped GEMM with parts removed or changed.

Run from the root of a checkout on one CUDA card:
``python3 grouped_variants.py [--parent DIR]``. It copies
``aphrodite_tpu_torch/csrc`` once per variant into
``build/grouped_variants/<name>/``, edits the copy of
``grouped_matmul.cuh`` (``VARIANTS``: text replaced in the source), builds
every copy with ``nvcc`` at once and calls each library's
``grouped_matmul_launch`` directly. ``--parent DIR`` adds the kernel of the
checkout unpacked at DIR (e.g. ``git archive <commit> | tar -x -C
build/parent``). In every copy an ``mbarrier`` wait that spins past 2^26
polls traps, so a variant that breaks the pipeline fails instead of
hanging the card.

The variants that compute y are first held against the plain version
(``ref_grouped_matmul``) on balanced and skewed MoE waves, at M = 240 and
on a straddling toy case. Then every variant, ``torch._grouped_mm`` and a
dense ``torch.matmul`` of the same operations are timed (CUDA events) at
phase 8's shapes (a Qwen1.5-MoE-A2.7B layer's gate|up and down, M = 65536
and 240, 60 experts), in 4 rounds whose order rotates, since the card
clocks down under sustained load; each line gives the middle two rounds'
mean and the range. Only variants timed in one run compare.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as c
from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops.grouped_matmul import ref_grouped_matmul

OUT = Path("build/grouped_variants")
HERE = Path(__file__).resolve().parent / "aphrodite_tpu_torch" / "csrc"

_PRODUCTS = ("for (int kk = 0; kk < kWgBK / 16; ++kk)",
             "for (int kk = 0; kk < 0; ++kk)")
_TMA_STORE = "if (it.row_lo <= r64 && r64 < M"
_DIRECT_STORE = "if (row < it.row_lo || row >= it.row_hi) continue;"
_NO_STORE = [(_TMA_STORE, "if (acc[0] == 1234.5f && it.row_lo <= r64 && "
                          "r64 < M"),
             (_DIRECT_STORE, "if (row < it.row_lo || row >= it.row_hi || "
                             "acc[0] != 1234.5f) continue;")]
# name: (replacements, computes y). Without products acc is never written,
# so the stores' guard on acc[0] keeps them.
VARIANTS = {
    "kernel": ([], True),
    "no multicast": ([("it.share = g0 == g1;", "it.share = false;")], True),
    "direct stores": ([(_TMA_STORE, "if (false && it.row_lo <= r64")], True),
    "no idle skip": ([("if (!it.store || it.row_lo >= r64 + 64 || "
                       "it.row_hi <= r64) {", "if (!it.store) {")], True),
    "no stores": (_NO_STORE, False),
    "no loads": ([("mbar_arrive_expect_tx(&full[stage], kStageBytes);",
                   "mbar_arrive_cluster(&full[stage], rank);"),
                  ("tma_load_2d(a, &x_map", "if (0) tma_load_2d(a, &x_map"),
                  ("tma_load_3d(a + kABytes",
                   "if (0) tma_load_3d(a + kABytes"),
                  ("tma_load_3d_multicast(a + kABytes",
                   "if (0) tma_load_3d_multicast(a + kABytes")], False),
    "no products": ([_PRODUCTS], False),
}
_TRAP = [("  uint32_t done;\n  do {",
          "  uint32_t done;\n  long long spins = 0;\n  do {"),
         ("  } while (!done);",
          "    if (++spins > (1ll << 26)) __trap();\n  } while (!done);")]


def start_build(name: str, src: Path, edits: list):
    d = OUT / name.replace(" ", "_")
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in src.glob("*.cu*"):
        shutil.copy(f, d / f.name)
    # The kernel lives in grouped_matmul.cuh (grouped_matmul.cu in
    # checkouts from before the fp16 instance): each edit goes to the file
    # that holds its text.
    for files, reps in ((("grouped_matmul.cuh", "grouped_matmul.cu"), edits),
                        (("hopper_common.cuh",), _TRAP)):
        paths = [d / f for f in files if (d / f).exists()]
        for a, b in reps:
            hit = [p for p in paths if a in p.read_text()]
            if not hit:
                raise ValueError(f"{name}: {a!r} not in {files}")
            hit[0].write_text(hit[0].read_text().replace(a, b))
    lib = d / "lib.so"
    cmd = [cuda_build._nvcc(), *cuda_build._FLAGS, "-I", str(d), "-o",
           str(lib), str(d / "grouped_matmul.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib, d


def launcher(lib_path: Path, src_dir: Path):
    """fn(x, w, offsets) -> y through the library's entry point; a parent
    kernel from before the persistent grid takes no grid argument."""
    fn = ctypes.CDLL(str(lib_path)).grouped_matmul_launch
    with_grid = "int grid," in (src_dir / "grouped_matmul.cu").read_text()
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, P, P, P, P, I, I, I, I] + ([I] if with_grid else []) \
        + [P]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def run(x, w, off):
        (M, K), (E, _, N) = x.shape, w.shape
        out = torch.empty((M, N), dtype=x.dtype, device=x.device)
        args = [1, x.data_ptr(), w.data_ptr(), off.data_ptr(),
                out.data_ptr(), M, K, N, E] + ([sms] if with_grid else [])
        cuda_build.check(fn(*args, cuda_build.stream(x.device)),
                         "grouped_matmul_launch")
        return out
    return run


def operands(gen, M: int, K: int, N: int, E: int):
    x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((E, K, N), generator=gen, device="cuda")
         * (0.5 / K ** 0.5)).bfloat16()
    return x, w


def main() -> int:
    if not torch.cuda.is_available():
        print("grouped_variants: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of another checkout to time")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"# card: {card}", flush=True)
    jobs = {n: (start_build(n, HERE, e), y) for n, (e, y) in VARIANTS.items()}
    if args.parent:
        src = Path(args.parent).resolve() / "aphrodite_tpu_torch" / "csrc"
        jobs["parent"] = (start_build("parent", src, []), True)
    t0 = time.perf_counter()
    runs, computes = {}, {}
    for name, ((proc, lib, d), ys) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"# ptxas {name}: {line.strip()}", flush=True)
        runs[name], computes[name] = launcher(lib, d), ys
    print(f"# built in {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = [("toy straddle", 300, 192, 320,
               c.sized_offsets([20, 0, 45, 13, 0, 50, 172]))]
    for M, skewed in ((65536, False), (65536, True), (240, False)):
        off = c.group_offsets(gen, M, skewed)
        checks += [(f"{g} M={M} {'skewed' if skewed else 'balanced'}", M, K,
                    N, off) for g, (K, N) in c.MOE_GEMMS.items()]
    for label, M, K, N, off in checks:
        x, w = operands(gen, M, K, N, off.numel() - 1)
        ref = ref_grouped_matmul(x.float(), w.float(), off)
        for name, run in runs.items():
            if not computes[name]:
                continue
            y = run(x, w, off)
            torch.cuda.synchronize()
            err = (y.float() - ref).abs().max().item()
            if not err <= c.TOL["bfloat16"]:
                raise AssertionError(f"{name} {label}: max_abs_err {err}")
        print(f"# {label}: every variant that computes y within "
              f"{c.TOL['bfloat16']} of the plain version", flush=True)
        del x, w, ref

    totals: dict[tuple[int, str], float] = {}
    for M in (65536, 240):
        off = c.group_offsets(gen, M, False)
        for g, (K, N) in c.MOE_GEMMS.items():
            x, w = operands(gen, M, K, N, c.MOE_E)
            ends, wd = off[1:].contiguous(), w[0]
            fns = {n: (lambda run=run: run(x, w, off))
                   for n, run in runs.items()}
            fns["_grouped_mm"] = lambda: torch._grouped_mm(x, w, offs=ends)
            if M > 4096:
                fns["dense matmul"] = lambda: x @ wd
            names = list(fns)
            got = {n: [] for n in names}
            reps = 20 if M > 4096 else 100
            for r in range(4):
                order = names[r:] + names[:r]
                for n in (order[::-1] if r % 2 else order):
                    got[n].append(c.cuda_ms(fns[n], reps))
            line = f"# {g} M={M}:"
            for n in names:
                v = sorted(got[n])
                mid = (v[1] + v[2]) / 2
                totals[(M, n)] = totals.get((M, n), 0.0) + mid
                line += f" {n} {mid:.4f} [{v[0]:.4f}-{v[-1]:.4f}];"
            print(line, flush=True)
            del x, w
    for M in (65536, 240):
        print(f"# a layer's 2 GEMMs, M={M}: " + "; ".join(
            f"{n} {t:.4f} ms" for (m, n), t in totals.items() if m == M),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
