"""Linear application, unquantized path. Weights keep the JAX package's
``[in, out]`` layout, so a projection is ``x @ w``."""
from __future__ import annotations

from typing import Optional

import torch


def apply_linear(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = x @ w
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w accumulated and returned in float32 (no rounding of the
    product to a 16-bit type)."""
    if x.dtype == torch.float32:
        return x @ w.float()
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()
