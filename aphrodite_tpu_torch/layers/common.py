"""Shared functional layers: norms and activations (plain PyTorch)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm in fp32, cast back to the input dtype. ``offset=1.0`` gives
    the Gemma convention (weight stored as w-1)."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * (weight.float() + offset)).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 (biased variance), cast back to the input dtype:
    the JAX package's ``models/vision.py:layer_norm``. ``weight`` /
    ``bias`` None: no scale / no shift."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


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


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# HF activation name -> dense (non-gated) activation: the JAX package's
# ``models/llama_variants.py:_DENSE_ACTS`` (gelu_new and gelu_fast are the
# tanh approximation; "gelu" is exact here, unlike ACT2MUL's).
DENSE_ACTS = {
    "gelu_new": _gelu_tanh,
    "gelu_pytorch_tanh": _gelu_tanh,
    "gelu_fast": _gelu_tanh,
    "gelu": F.gelu,
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
}
