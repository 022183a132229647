"""Seeded Gumbel-max sampling: the token each row draws from its logprobs.

``gumbel_sample(logprobs, seeds, out_len, step_offset)`` computes the
sampled branch of the JAX package's ``sample_tokens``
(``aphrodite_tpu/sample/sampler.py:494-501``)::

    key_r  = fold_in(fold_in(PRNGKey(seeds[r]), out_len[r] + step_offset), 2)
    noisy  = where(isfinite(lp[r]), lp[r] + gumbel(key_r, (V,)), -inf)
    token  = argmax(noisy)          # first index on ties; 0 if all -inf

On CUDA tensors it launches the hand-written kernel of
``csrc/gumbel_sample.cu``, which draws each column's threefry bits in
registers and never writes the [R, V] noise. On CPU tensors it runs the
plain version ``ref_gumbel_sample`` on ``sample/rng.py``'s stream. The bits
and uniforms of the two are equal; the Gumbel values differ by the last
ulp of the logs, so the tokens are equal wherever a row's two best noisy
scores lie further apart than that (``chip_smoke.py`` phase 2).
"""
from __future__ import annotations

import ctypes

import torch

from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.sample import rng

# int32 operations a column of the kernel: threefry2x32's 20 rounds (add,
# funnel shift, xor), its first add and 5 key injections of 2 adds, and the
# xor, shift and or that make the float (``csrc/gumbel_sample.cu``).
INT_OPS_PER_COLUMN = 74

_LAUNCH = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_void_p]
_NOISE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
          ctypes.c_void_p]
_SLICE: list[int] = []


def ref_gumbel_sample(logprobs: torch.Tensor, seeds: torch.Tensor,
                      out_len: torch.Tensor, step_offset: int = 0
                      ) -> torch.Tensor:
    """Plain PyTorch version: the noise from ``sample/rng.py``, then the
    masked argmax."""
    _, key = rng.sample_keys(seeds, out_len.long() + step_offset)
    noise = rng.gumbel(key, logprobs.shape[-1:])
    lp = logprobs.float()
    noisy = torch.where(torch.isfinite(lp), lp + noise, float("-inf"))
    return torch.argmax(noisy, dim=-1)


def _check(logprobs, seeds, out_len):
    if logprobs.dim() != 2 or logprobs.dtype != torch.float32:
        raise ValueError(f"logprobs must be [R, V] float32, got "
                         f"{logprobs.dtype} {tuple(logprobs.shape)}")
    R = logprobs.shape[0]
    if seeds.shape != (R,) or out_len.shape != (R,):
        raise ValueError(f"seeds and out_len must be [{R}], got "
                         f"{tuple(seeds.shape)} and {tuple(out_len.shape)}")
    for t in (seeds, out_len):
        if t.device != logprobs.device:
            raise ValueError(f"inputs on {logprobs.device} and {t.device}")
    return (seeds.to(torch.int64).contiguous(),
            out_len.to(torch.int32).contiguous())


def gumbel_sample(logprobs: torch.Tensor, seeds: torch.Tensor,
                  out_len: torch.Tensor, step_offset: int = 0
                  ) -> torch.Tensor:
    """Each row's Gumbel-max token [R] int64 from fp32 ``logprobs`` [R, V],
    its seed ``seeds`` [R] (31-bit values) and its counter ``out_len`` [R]
    + ``step_offset``."""
    if logprobs.device.type == "cpu":
        return ref_gumbel_sample(logprobs, seeds, out_len, step_offset)
    seeds, out_len = _check(logprobs, seeds, out_len)
    lp = logprobs.contiguous()
    R, V = lp.shape
    tokens = torch.empty((R,), dtype=torch.int64, device=lp.device)
    if R == 0 or V == 0:
        return tokens.zero_()
    if not _SLICE:
        _SLICE.append(cuda_build.entry("gumbel_sample",
                                       "gumbel_sample_slice", [])())
    blocks = -(-V // _SLICE[0])
    partial = torch.empty((R, blocks), dtype=torch.int64, device=lp.device)
    fn = cuda_build.entry("gumbel_sample", "gumbel_sample_launch", _LAUNCH)
    err = fn(lp.data_ptr(), seeds.data_ptr(), out_len.data_ptr(),
             int(step_offset), R, V, partial.data_ptr(), tokens.data_ptr(),
             cuda_build.stream(lp.device))
    cuda_build.check(err, "gumbel_sample")
    gumbel_sample.launches += 1
    return tokens


# Launches of the CUDA kernel (a run sets it to 0 and reads it after).
gumbel_sample.launches = 0


def gumbel_noise(seeds: torch.Tensor, out_len: torch.Tensor,
                 step_offset: int, V: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's noise alone on the card, for checking it against the
    plain stream: (bits [R, V] int64, uniforms and Gumbel values [R, V]
    float32) of every row's sample key. Not counted as a launch of
    ``gumbel_sample``."""
    if seeds.device.type != "cuda":
        raise ValueError("gumbel_noise runs the kernel: CUDA tensors only")
    seeds, out_len = seeds.to(torch.int64).contiguous(), \
        out_len.to(torch.int32).contiguous()
    R = seeds.shape[0]
    bits = torch.empty((R, V), dtype=torch.int32, device=seeds.device)
    unif = torch.empty((R, V), dtype=torch.float32, device=seeds.device)
    noise = torch.empty_like(unif)
    fn = cuda_build.entry("gumbel_sample", "gumbel_noise_launch", _NOISE)
    err = fn(seeds.data_ptr(), out_len.data_ptr(), int(step_offset), R, V,
             bits.data_ptr(), unif.data_ptr(), noise.data_ptr(),
             cuda_build.stream(seeds.device))
    cuda_build.check(err, "gumbel_noise")
    return bits.long() & rng.MASK32, unif, noise
