"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, then loaded with ``ctypes``. A
library is built at first use into ``build/torch_kernels/`` at the root of
the checkout (``APHRODITE_TORCH_KERNEL_DIR`` overrides it), under a name
keyed by a hash of its sources and flags, so an edited source rebuilds and
an unchanged one loads at once. ``build_all`` starts one ``nvcc`` per
source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIBS: dict[str, ctypes.CDLL] = {}
# x's dtype code of the quantized GEMMs' CUDA-core kernels
# (csrc/quant_matmul.cu): fp32 alone. bf16 and fp16 x run on
# ops/w4_wgmma.py's instances, and the grouped GEMM and the attention
# kernels take the attention table (ops/ragged_paged_attention.py
# DTYPE_CODES: fp32 0, bf16 1, fp16 2).
GEMM_DTYPE_CODES = {torch.float32: 0}
_FNS: dict[tuple[str, str], object] = {}


def build_dir() -> Path:
    default = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
    return Path(os.environ.get("APHRODITE_TORCH_KERNEL_DIR", default))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for csrc/<name>.cu; None when the library is built."""
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
           str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: list[str]) -> float:
    """Build every named library in parallel; returns the seconds taken."""
    t0 = time.perf_counter()
    jobs = {n: _start_build(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish_build(n, job)
    return time.perf_counter() - t0


def entry(name: str, symbol: str, argtypes: list):
    """The C entry point `symbol` of csrc/<name>.cu, building and loading
    the library at first use. Every entry returns a cudaError_t."""
    fn = _FNS.get((name, symbol))
    if fn is not None:
        return fn
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _FNS[(name, symbol)] = fn
    return fn


def ptxas_report(name: str) -> str:
    """What ptxas said about the kernel's registers and shared memory."""
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def stream(device) -> int:
    """The raw handle of the current CUDA stream of ``device`` (what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a Stream object on every launch)."""
    idx = device.index
    return torch._C._cuda_getCurrentRawStream(
        idx if idx is not None else torch.cuda.current_device())


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


_SPLIT_WORKSPACE: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


def split_workspace(device, floats: int, tiles: int) -> tuple[int, int]:
    """Pointers to ``floats`` fp32 of scratch and ``tiles`` zeroed int32
    counters on ``device``, for the K splits of the quantized GEMMs (fp32
    partial sums and the counters by which the last block of a tile finds
    itself; each kernel leaves its counters at zero). Grown as needed and
    reused by every launch (launches on one stream run one after the
    other)."""
    partial, counters = _SPLIT_WORKSPACE.get(device.index, (None, None))
    if partial is None or partial.numel() < floats:
        partial = torch.empty(max(floats, 1 << 20), dtype=torch.float32,
                              device=device)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(max(tiles, 4096), dtype=torch.int32,
                               device=device)
    _SPLIT_WORKSPACE[device.index] = (partial, counters)
    return partial.data_ptr(), counters.data_ptr()


# cudaDevAttrMaxSharedMemoryPerBlockOptin and the SM count of an H100: what
# launches are sized for on the CPU, where no card can be asked.
H100_SMEM_OPTIN = 232448
H100_SMS = 132
_SMEM_OPTIN: list[int] = []
_SMS: dict[int, int] = {}


def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device, read once."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def smem_optin() -> int:
    """The shared memory a block of the card may opt in to, in bytes, read
    once from the device through an attention library's
    ``attn_smem_optin`` (``csrc/attn_common.cuh``)."""
    if not _SMEM_OPTIN:
        fn = entry("ragged_paged_attention", "attn_smem_optin",
                   [ctypes.c_void_p])
        val = ctypes.c_int(0)
        check(fn(ctypes.addressof(val)), "attn_smem_optin")
        _SMEM_OPTIN.append(val.value)
    return _SMEM_OPTIN[0]


def check_smem(what: str, need: int, allowed: int) -> None:
    """Raise, naming both sizes, when a launch needs more shared memory
    than the card allows a block."""
    if need > allowed:
        raise RuntimeError(
            f"{what} needs {need} bytes of shared memory per block; the card "
            f"allows {allowed}")


def fit_warps(what: str, smem_bytes, allowed: int) -> int:
    """Warps per block for a kernel whose warps each stage their own tiles:
    4, else 2, else 1, the first whose ``smem_bytes(warps)`` fits. Raises,
    naming the bytes, when not even one warp fits."""
    for warps in (4, 2):
        if smem_bytes(warps) <= allowed:
            return warps
    check_smem(what, smem_bytes(1), allowed)
    return 1
