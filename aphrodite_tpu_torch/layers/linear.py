"""Linear application. Weights keep the JAX package's ``[in, out]``
layout, so a projection is ``x @ w``. A weight is a tensor, or a dict of
tensors in a quantized layout whose format tag (``"w4a16"`` or
``"w8a16"``) the caller passes."""
from __future__ import annotations

from typing import Optional, Union

import torch

Weight = Union[torch.Tensor, dict]


def apply_linear(x: torch.Tensor, w: Weight,
                 bias: Optional[torch.Tensor] = None,
                 fmt: Optional[str] = None) -> torch.Tensor:
    if isinstance(w, dict):
        from aphrodite_tpu_torch.ops import quant_gemm
        if fmt == "w8a16":
            out = quant_gemm.w8a16_matmul(x, w["qweight"], w["scales"])
        elif fmt == "w4a16":
            out = quant_gemm.w4a16_matmul(
                x, w.get("qweight"), w["scales"], w.get("zeros"),
                input_perm=w.get("input_perm"),
                qpacked=w.get("qweight_packed"))
        else:
            raise NotImplementedError(
                f"quantized format {fmt!r} is not ported")
    else:
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
