"""Weight-only quantized matmuls (W8A16, W4A16), routed by M.

Counterpart of ``w8a16_matmul`` and ``w4a16_matmul`` in the JAX package's
``ops/quant_gemm.py`` with its Pallas kernels on:

- M <= 256 (decode): the hand-written kernels of ``ops/quant_matmul.py``,
  one per weight layout, which dequantize in registers with the direct
  form ``(q - z) * s`` in fp32.
- M > 256 (prefill waves): W is dequantized with the same direct form in
  fp32, eight groups of rows at a time, each slab cast once into a [K, N]
  tensor of x's dtype (no fp32 copy of the whole W), and multiplied with an
  fp32-accumulating ``matmul_f32``, as the JAX package leaves that product
  to XLA.

``input_perm`` (GPTQ desc_act) reorders x's columns before the product.
"""
from __future__ import annotations

from typing import Optional

import torch

from aphrodite_tpu_torch.layers.linear import matmul_f32
from aphrodite_tpu_torch.ops import quant_matmul as qm

DECODE_M = 256   # largest M the kernels take on the main path
_SLAB_GROUPS = 8  # groups of W rows dequantized in fp32 at a time (M > 256)


def w8a16_matmul(x: torch.Tensor, qweight: torch.Tensor,
                 scales: torch.Tensor) -> torch.Tensor:
    """Weight-only int8 [K, N] with per-output-channel scales [N]."""
    if x.shape[0] <= DECODE_M:
        return qm.w8a16_matmul(x, qweight, scales)
    acc = matmul_f32(x, qweight.to(x.dtype))  # int8 is exact in bf16
    return (acc * scales.float()[None, :]).to(x.dtype)


def w4a16_matmul(x: torch.Tensor, qweight: Optional[torch.Tensor],
                 scales: torch.Tensor, zeros: torch.Tensor,
                 input_perm: Optional[torch.Tensor] = None,
                 qpacked: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Group-quantized 4-bit weights: uint4-in-int8 ``qweight`` [K, N] or
    packed ``qpacked`` uint8 [K/2, N]; scales/zeros fp32 [K/group, N]."""
    if zeros is None:
        raise NotImplementedError("W4A16 without zero points is not ported")
    if input_perm is not None:
        x = x.index_select(-1, input_perm.long())
    if x.shape[0] <= DECODE_M:
        if qpacked is not None:
            return qm.w4a16_packed_matmul(x, qpacked, scales, zeros)
        return qm.w4a16_matmul(x, qweight, scales, zeros)
    G, N = scales.shape
    if qpacked is None:
        w = torch.empty((qweight.shape[0], N), dtype=x.dtype, device=x.device)
        _dequant_w4_into(w, lambda a, b: qweight[a:b], scales, zeros)
    else:  # low nibbles are W's first half of rows, high nibbles its second
        h = qpacked.shape[0]
        w = torch.empty((2 * h, N), dtype=x.dtype, device=x.device)
        _dequant_w4_into(w[:h], lambda a, b: qpacked[a:b] & 0xF,
                         scales[:G // 2], zeros[:G // 2])
        _dequant_w4_into(w[h:], lambda a, b: (qpacked[a:b] >> 4) & 0xF,
                         scales[G // 2:], zeros[G // 2:])
    acc = matmul_f32(x, w)
    del w  # free W before the cast allocates the output
    return acc.to(x.dtype)


def _dequant_w4_into(out: torch.Tensor, rows, scales: torch.Tensor,
                     zeros: torch.Tensor) -> None:
    """out [K, N] = (q - z) * s in fp32, cast to out's dtype a slab of
    ``_SLAB_GROUPS`` groups at a time; ``rows(a, b)`` gives q's rows a:b."""
    K, N = out.shape
    g = K // scales.shape[0]
    step = _SLAB_GROUPS * g
    for a in range(0, K, step):
        b = min(K, a + step)
        w = rows(a, b).float().view(-1, g, N)
        w.sub_(zeros[a // g:b // g, None]).mul_(scales[a // g:b // g, None])
        out[a:b] = w.view(-1, N)
