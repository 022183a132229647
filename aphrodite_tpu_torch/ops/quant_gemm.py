"""Quantized matmuls (W8A16, W4A16, FP8, int8 W8A8), routed by M.

Counterpart of ``w8a16_matmul``, ``w4a16_matmul``, ``fp8_matmul`` and
``int8_matmul`` in the JAX package's ``ops/quant_gemm.py`` with its Pallas
kernels on:

- M <= 256 (decode): the hand-written kernels of ``ops/quant_matmul.py``,
  one per weight layout. The uint4 layout dequantizes in registers with
  the direct form ``(q - z) * s`` in fp32; the packed and native-int4
  layouts (``qweight4``, ``loader.weights.realize_int4_leaves``) take the
  TPU int4 kernel's group-wise form on the card in bf16 and fp16; every
  layout computes in x's dtype and returns it, as the TPU kernels do.
- ``qweight4`` on CPU tensors keeps the JAX package's bands: M <= 64 the
  grouped product ``w4a16_int4_grouped`` (its XLA int4 dot), 64 < M <= 256
  the int4 kernel's plain version. On CUDA tensors every M <= 256 goes to
  the int4 kernel, which computes the same function at any M: XLA's fused
  int4 dot has no counterpart on the card that avoids writing W out in
  x's dtype.
- M > 256 (prefill waves), every layout: W is dequantized with the direct
  form in fp32, eight groups of rows at a time, each slab cast once into a
  [K, N] tensor of x's dtype (no fp32 copy of the whole W), and multiplied
  with an fp32-accumulating ``matmul_f32``, as the JAX package leaves that
  product to XLA.

``input_perm`` (GPTQ desc_act) reorders x's columns before the product.

FP8 (``fp8_matmul``, ``quant_gemm.py:74-119``, which XLA computes in JAX):
with per-column weight scales and no static input scale, M <= 256 runs the
hand-written e4m3 kernel (``quant_matmul.fp8_matmul``: ``w4_wgmma``'s
"fp8" layout in bf16 or fp16); for W8A8 the activations are first rounded
to e4m3 per token (torch ops: one row reduction and an elementwise pass, as
XLA computes them; the kernel takes x held in x's dtype, exact, and the
row scales). Everything else (M > 256, blockwise weight scales, a static
input scale; the last two reach the port only with checkpoints) runs the
JAX function's own torch ops: the weights cast to x's dtype (e4m3 is exact
in bf16 and fp16) and an fp32-accumulating ``matmul_f32``, scaled as JAX
scales. int8 W8A8 (``int8_matmul``, ``:60-71``) is an XLA dot in JAX: here
``torch._int_mm`` (int32 accumulation, exact) at every M.
"""
from __future__ import annotations

from typing import Optional

import torch

from aphrodite_tpu_torch.layers.linear import matmul_f32
from aphrodite_tpu_torch.ops import quant_matmul as qm
from aphrodite_tpu_torch.utils import to_fp8

DECODE_M = 256   # largest M the kernels take on the main path
GROUPED_M = 64   # largest M of the grouped int4 product on CPU tensors
_SLAB_GROUPS = 8  # groups of W rows dequantized in fp32 at a time (M > 256)
# torch._int_mm on the card takes M > 16 (and K, N multiples of 8): fewer
# rows are padded with zeros to this many.
INT_MM_MIN_M = 17


def w8a16_matmul(x: torch.Tensor, qweight: torch.Tensor,
                 scales: torch.Tensor) -> torch.Tensor:
    """Weight-only int8 [K, N] with per-output-channel scales [N]."""
    if x.shape[0] <= DECODE_M:
        return qm.w8a16_matmul(x, qweight, scales)
    acc = matmul_f32(x, qweight.to(x.dtype))  # int8: exact in bf16, fp16
    return (acc * scales.float()[None, :]).to(x.dtype)


def int8_matmul(x: torch.Tensor, qweight: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
    """int8 W8A8: x quantized per token to int8 with the scale amax / 127
    (XLA's ``amax * (1 / 127)``, round half to even, clipped), an int32
    product, then (acc * xs) * s[n] in fp32."""
    xf = x.float()
    xs = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) * (1.0 / 127.0),
                     min=1e-8)
    xq = torch.clamp(torch.round(xf / xs), -128, 127).to(torch.int8)
    M = xq.shape[0]
    if x.is_cuda and M < INT_MM_MIN_M:
        xq = torch.cat([xq, xq.new_zeros((INT_MM_MIN_M - M, xq.shape[1]))])
    acc = torch._int_mm(xq, qweight)[:M]
    return (acc.float() * xs * scales.float()[None, :]).to(x.dtype)


def fp8_quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token e4m3 activations (``quant_gemm.py:102-107``):
    (x / xs rounded to e4m3 held in x's dtype, exact; xs fp32 [M, 1]), xs =
    max(amax * (1 / 448), 1e-10)."""
    xf = x.float()
    xs = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) * (1.0 / 448.0),
                     min=1e-10)
    return to_fp8(xf / xs, torch.float8_e4m3fn).to(x.dtype), xs


def fp8_matmul(x: torch.Tensor, qweight: torch.Tensor,
               weight_scale: torch.Tensor,
               input_scale: Optional[torch.Tensor] = None,
               act_quant: bool = False) -> torch.Tensor:
    """e4m3fn weights [K, N] with per-column scales [N] or blockwise
    [K/b0, N/b1], optionally with e4m3 activations (``act_quant``): dynamic
    per-token scales, or the static per-tensor ``input_scale``."""
    K, N = qweight.shape
    M = x.shape[0]
    blockwise = (weight_scale.dim() == 2
                 and tuple(weight_scale.shape) != (1, N))
    if not blockwise and input_scale is None and M <= DECODE_M:
        ws = weight_scale.reshape(N)
        if not act_quant:
            return qm.fp8_matmul(x, qweight, ws)
        x8, xs = fp8_quantize_rows(x)
        return qm.fp8_matmul(x8, qweight, ws, xs.reshape(M))
    wf = qweight.to(x.dtype)
    if blockwise:
        Kb, Nb = weight_scale.shape
        if K % Kb or N % Nb:
            raise ValueError(
                f"blockwise scale grid {tuple(weight_scale.shape)} does not "
                f"divide weight {tuple(qweight.shape)}")
        b0, b1 = K // Kb, N // Nb
        wf = (wf.reshape(Kb, b0, Nb, b1)
              * weight_scale.to(x.dtype)[:, None, :, None]).reshape(K, N)
    if act_quant:
        if input_scale is None:
            x8, xs = fp8_quantize_rows(x)
        else:
            xs = input_scale.float().reshape(1, 1)
            x8 = to_fp8(x.float() / xs, torch.float8_e4m3fn).to(x.dtype)
        acc = matmul_f32(x8, wf) * xs
    else:
        acc = matmul_f32(x, wf)
    if not blockwise:
        acc = acc * weight_scale.float().reshape(1, N)
    return acc.to(x.dtype)


def w4a16_int4_grouped(x: torch.Tensor, q4p: torch.Tensor,
                       scales: torch.Tensor,
                       zeros: Optional[torch.Tensor]) -> torch.Tensor:
    """The JAX package's small-M int4 product (``quant_gemm.py:147-170``)
    in fp32: one product per group, the scales contracted over the groups,
    then ``sum(x_g) @ (z * s)`` subtracted. q4p: ``pack_int4`` bytes."""
    M, K = x.shape
    G, N = scales.shape
    xg = x.float().reshape(M, G, K // G).transpose(0, 1)       # [G, M, g]
    dg = xg @ qm.unpack_int4(q4p).float().reshape(G, K // G, N)
    y = torch.einsum("gmn,gn->mn", dg, scales.float())
    if zeros is not None:
        y = y - xg.sum(dim=2).t() @ (zeros.float() * scales.float())
    return y.to(x.dtype)


def w4a16_matmul(x: torch.Tensor, qweight: Optional[torch.Tensor],
                 scales: torch.Tensor, zeros: torch.Tensor,
                 input_perm: Optional[torch.Tensor] = None,
                 qpacked: Optional[torch.Tensor] = None,
                 qweight4: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Group-quantized 4-bit weights: uint4-in-int8 ``qweight`` [K, N],
    packed ``qpacked`` uint8 [K/2, N], or signed int4 ``qweight4`` packed as
    uint8 [K/2, N] (with zeros shifted by -8); scales/zeros fp32
    [K/group, N]."""
    if zeros is None:
        raise NotImplementedError("W4A16 without zero points is not ported")
    if input_perm is not None:
        x = x.index_select(-1, input_perm.long())
    M = x.shape[0]
    if qweight4 is not None and M <= DECODE_M:
        if x.device.type == "cpu" and M <= GROUPED_M:
            return w4a16_int4_grouped(x, qweight4, scales, zeros)
        return qm.w4a16_int4_matmul(x, qweight4, scales, zeros)
    if M <= DECODE_M:
        if qpacked is not None:
            return qm.w4a16_packed_matmul(x, qpacked, scales, zeros)
        return qm.w4a16_matmul(x, qweight, scales, zeros)
    G, N = scales.shape
    if qweight4 is not None:  # rows 2r, 2r + 1 in one byte: whole slabs
        w = torch.empty((2 * qweight4.shape[0], N), dtype=x.dtype,
                        device=x.device)
        _dequant_w4_into(w, lambda a, b: qm.unpack_int4(
            qweight4[a // 2:b // 2]), scales, zeros)
    elif qpacked is None:
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
