"""Linear application. Weights keep the JAX package's ``[in, out]``
layout, so a projection is ``x @ w``. A weight is a tensor, or a dict of
tensors in a quantized layout whose format tag (``"w4a16"``, ``"w8a16"``,
``"int8"``, ``"fp8"`` or ``"fp8_w8a8"``, as in
``aphrodite_tpu/layers/linear.py:29-41``) the caller passes."""
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
        elif fmt == "int8":
            out = quant_gemm.int8_matmul(x, w["qweight"], w["scales"])
        elif fmt in ("fp8", "fp8_w8a8"):
            scale = w.get("weight_scale_block")
            out = quant_gemm.fp8_matmul(
                x, w["qweight"],
                w["weight_scale"] if scale is None else scale,
                input_scale=w.get("input_scale"),
                act_quant=fmt == "fp8_w8a8")
        elif fmt == "w4a16":
            out = quant_gemm.w4a16_matmul(
                x, w.get("qweight"), w["scales"], w.get("zeros"),
                input_perm=w.get("input_perm"),
                qpacked=w.get("qweight_packed"), qweight4=w.get("qweight4"))
        else:
            raise NotImplementedError(
                f"quantized format {fmt!r} is not ported")
    else:
        out = x @ w
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The batched product a [B, M, K] @ b [B, K, N] with fp32 sums,
    returned in float32: what ``jnp.einsum(...,
    preferred_element_type=f32)`` gives before its cast. A 16-bit CUDA
    ``torch.bmm`` may reduce in 16 bits (PyTorch's default
    ``allow_{bf16,fp16}_reduced_precision_reduction``), so on the card the
    product asks cuBLAS for fp32 output."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b.float())
    if a.device.type != "cpu":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w accumulated and returned in float32 (no rounding of the
    product to a 16-bit type)."""
    if x.dtype == torch.float32:
        return x @ w.float()
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()
