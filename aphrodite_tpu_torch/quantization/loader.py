"""On-the-fly weight quantization and the true-4-bit packing.

Counterpart of the on-the-fly part of the JAX package's
``quantization/loader.py:quantize_stacked_params`` (``q_int8`` for w8a16,
``q_int4`` for gptq/awq) and of ``loader/weights.py:_pack_w4_leaves``.
Written in torch on the weights' own device with the same fp32 arithmetic
and round-half-to-even (``torch.round``), so the leaves equal the JAX
package's for the same fp weights. XLA compiles a division by a constant
into a product with the constant's fp32 reciprocal, so the scales here are
``range * (1 / 15)`` and ``amax * (1 / 127)``: a true division differs
from the JAX scales by one ulp in about two of three groups.
"""
from __future__ import annotations

import torch

from aphrodite_tpu_torch.quantization.base import QuantizationConfig


def quantize_int8(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """[K, N] -> {"qweight": int8 [K, N], "scales": fp32 [N]}: symmetric
    per-output-channel int8."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=0) * (1.0 / 127.0), min=1e-8)
    q = torch.clamp(torch.round(w / scale[None, :]), -128, 127)
    return {"qweight": q.to(torch.int8), "scales": scale}


def quantize_int4(w: torch.Tensor, group: int) -> dict[str, torch.Tensor]:
    """[K, N] -> {"qweight": int8 [K, N] holding 0..15, "scales", "zeros":
    fp32 [K/group, N]}: asymmetric uint4 per group of ``group`` rows."""
    K, N = w.shape
    wg = w.float().reshape(K // group, group, N)
    wmax = wg.amax(dim=1)
    wmin = wg.amin(dim=1)
    scale = torch.clamp((wmax - wmin) * (1.0 / 15.0), min=1e-8)
    zero = torch.clamp(torch.round(-wmin / scale), 0, 15)
    q = torch.clamp(torch.round(wg / scale[:, None, :]) + zero[:, None, :],
                    0, 15)
    return {"qweight": q.to(torch.int8).reshape(K, N), "scales": scale,
            "zeros": zero}


def w4_group(qcfg: QuantizationConfig, K: int) -> int:
    """The group size a [K, N] weight is quantized with."""
    g = qcfg.group_size
    return g if 0 < g <= K else K


def w4_packs(K: int, group: int) -> bool:
    """Whether a W4 leaf of K rows is stored packed. The condition is the
    JAX loader's (a Mosaic tiling rule there), kept so that both packages
    hold the same leaves."""
    return group > 0 and K % 2 == 0 and (K // 2) % (8 * group) == 0


def pack_w4(q: torch.Tensor) -> torch.Tensor:
    """uint4-in-int8 [K, N] -> uint8 [K/2, N] "global-half" packing: byte
    [r, n] holds row r in bits 0-3 and row r + K/2 in bits 4-7."""
    K = q.shape[0]
    lo = q[:K // 2].to(torch.uint8)
    hi = q[K // 2:].to(torch.uint8)
    return lo | (hi << 4)


def quantize_weight(w: torch.Tensor,
                    qcfg: QuantizationConfig) -> dict[str, torch.Tensor]:
    """One fp weight [K, N] -> its quantized leaves, packed where the JAX
    loader packs."""
    if qcfg.method == "w8a16":
        return quantize_int8(w)
    if qcfg.method in ("gptq", "awq"):
        group = w4_group(qcfg, w.shape[0])
        leaves = quantize_int4(w, group)
        if w4_packs(w.shape[0], group):
            leaves["qweight_packed"] = pack_w4(leaves.pop("qweight"))
        return leaves
    raise NotImplementedError(f"quantization method {qcfg.method!r}")
