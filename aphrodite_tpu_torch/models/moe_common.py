"""Shared sparse-MoE routing and expert combine.

Counterpart of the JAX package's ``models/moe_common.py`` for one card.
Routing (which experts, with what weights) is softmax top-k; the expert
compute has two routes, chosen by the JAX rule (``moe_combine``):

- grouped (T * k >= 4 E, prefill waves): the T * k (token, choice) rows
  are sorted by expert and the expert projections run as two grouped GEMMs
  (``ops/grouped_matmul.py``: gate|up fused on N, then down), so the work
  scales with k, not E;
- dense (decode): every expert over every token as batched products over
  the stacked expert weights, weighted by the dense [T, E] gate. Each
  expert's weights are read once a step, which is what decode is bound by.

Expert weights are stacked on a leading expert axis in the ``[in, out]``
layout: gate|up ``[E, H, 2I]`` (the JAX ``we_gate`` and ``we_up``
concatenated on N) and down ``[E, I, H]``. Quantized experts and expert
parallelism are not ported.
"""
from __future__ import annotations

import torch

from aphrodite_tpu_torch.layers.common import silu_and_mul
from aphrodite_tpu_torch.layers.linear import matmul_f32
from aphrodite_tpu_torch.ops.grouped_matmul import grouped_matmul

# The grouped route is taken from this many routed rows per expert on.
GROUPED_ROWS_PER_EXPERT = 4


def softmax_topk_routing(h: torch.Tensor, router: torch.Tensor, top_k: int,
                         norm_topk: bool
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mixtral-style routing: fp32 logits h @ router [H, E], softmax over
    all experts, top-k, optionally renormalized to sum 1. Returns (topi
    [T, k] int64, topw [T, k] fp32), best first."""
    probs = torch.softmax(matmul_f32(h, router), dim=-1)
    topw, topi = torch.topk(probs, top_k, dim=-1)
    if norm_topk:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    return topi, topw


def moe_combine(h: torch.Tensor, w_gate_up: torch.Tensor,
                w_down: torch.Tensor, topi: torch.Tensor,
                topw: torch.Tensor) -> torch.Tensor:
    """Weighted combine of each token's top-k experts: h [T, H] -> [T, H].
    The routing weights are cast to h's dtype first, as in JAX."""
    E = w_gate_up.shape[0]
    topw = topw.to(h.dtype)
    if topi.numel() >= GROUPED_ROWS_PER_EXPERT * E:
        return _grouped_moe(h, w_gate_up, w_down, topi, topw)
    return _dense_moe(h, w_gate_up, w_down, topi, topw)


def _grouped_moe(h: torch.Tensor, w_gate_up: torch.Tensor,
                 w_down: torch.Tensor, topi: torch.Tensor,
                 topw: torch.Tensor) -> torch.Tensor:
    """Sorted-row grouped GEMMs. The rows are sorted stably by expert id;
    the group offsets come from a search in the sorted ids, on the device
    (``torch.bincount`` would read its input's maximum on the host). The
    combine back to tokens inverts the permutation and sums each token's k
    weighted rows: no atomics, the same order every run. (JAX adds the rows
    into the tokens in sorted order; in fp32 the two agree to ~1e-7.)"""
    T, k = topi.shape
    E = w_gate_up.shape[0]
    flat = topi.reshape(-1)
    ids, order = torch.sort(flat, stable=True)
    offsets = torch.searchsorted(
        ids, torch.arange(E + 1, device=h.device, dtype=ids.dtype),
        out_int32=True)
    xs = h.index_select(0, order // k)
    gu = grouped_matmul(xs, w_gate_up, offsets)
    inter = gu.shape[1] // 2
    y = grouped_matmul(silu_and_mul(gu[:, :inter], gu[:, inter:]), w_down,
                       offsets)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=h.device))
    y = y.index_select(0, inv).view(T, k, -1)
    return (y * topw[:, :, None]).sum(dim=1)


def _dense_moe(h: torch.Tensor, w_gate_up: torch.Tensor,
               w_down: torch.Tensor, topi: torch.Tensor,
               topw: torch.Tensor) -> torch.Tensor:
    """Every expert over every token ([E, T, .] batched products), weighted
    by the dense gate [T, E] (zero where the expert was not chosen) and
    summed over experts. JAX scans the experts and adds in h's dtype one
    expert at a time; here the weighted products are summed at once."""
    E = w_gate_up.shape[0]
    gu = torch.matmul(h, w_gate_up)                      # [E, T, 2I]
    inter = gu.shape[-1] // 2
    y = torch.matmul(silu_and_mul(gu[..., :inter], gu[..., inter:]),
                     w_down)                             # [E, T, H]
    experts = torch.arange(E, device=h.device)
    gate = torch.where(topi[:, :, None] == experts, topw[:, :, None],
                       0).sum(dim=1)                     # [T, E]
    return (gate.t()[:, :, None] * y).sum(dim=0)
