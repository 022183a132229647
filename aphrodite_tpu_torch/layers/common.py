"""Shared functional layers: norms and activations (plain PyTorch)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm in fp32, cast back to the input dtype. ``offset=1.0`` gives
    the Gemma convention (weight stored as w-1)."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * (weight.float() + offset)).to(x.dtype)


def silu_and_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def gelu_and_mul(gate: torch.Tensor, up: torch.Tensor,
                 approximate: str = "tanh") -> torch.Tensor:
    return F.gelu(gate, approximate=approximate) * up


# HF activation name -> gated activation (the JAX package's ACT2MUL: its
# "gelu" is the tanh approximation too).
ACT2MUL = {
    "silu": silu_and_mul,
    "gelu": gelu_and_mul,
    "gelu_pytorch_tanh": gelu_and_mul,
}
