"""Sparse mixture-of-experts decoders: Mixtral, Qwen2-MoE, Qwen3-MoE, OLMoE
and DeepSeek V1.

Counterpart of the JAX package's ``models/mixtral.py``. Attention is the
Llama one (``models/llama.py``: both forwards, the window decode path
included); the MLP of a MoE layer is a ``SparseMoeBlock``: softmax top-k
routing and the expert combine of ``models/moe_common.py``, plus an
optional always-on shared expert, sigmoid-gated for Qwen2/3-MoE and
ungated for DeepSeek V1. Mixed stacks (DeepSeek's ``first_k_dense_replace``
/ ``moe_layer_freq``, Qwen2-MoE's ``decoder_sparse_step`` /
``mlp_only_layers``) give each layer its kind: a dense layer keeps the
Llama MLP (width ``intermediate_size``), a MoE layer holds the block
(expert width ``moe_intermediate_size``).

Quantized experts and expert parallelism are not ported: an engine built
with ``quantization=`` on these architectures raises.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from aphrodite_tpu_torch.config import ModelConfig
from aphrodite_tpu_torch.layers.common import silu_and_mul
from aphrodite_tpu_torch.layers.linear import matmul_f32
from aphrodite_tpu_torch.models.llama import (LlamaDecoderLayer,
                                              LlamaForCausalLM, _param)
from aphrodite_tpu_torch.models.moe_common import (moe_combine,
                                                   softmax_topk_routing)
from aphrodite_tpu_torch.quantization.base import QuantizationConfig


class SparseMoeBlock(nn.Module):
    """A MoE layer's weights: ``router`` [H, E], experts ``we_gate_up``
    [E, H, 2I] and ``we_down`` [E, I, H]; with a shared expert of width Is,
    ``ws_gate_up`` [H, 2Is], ``ws_down`` [Is, H] and, when gated,
    ``ws_route`` [H, 1]."""

    def __init__(self, H: int, E: int, inter: int, shared_inter: int,
                 shared_gate: bool, dtype, device) -> None:
        super().__init__()
        mk = dict(dtype=dtype, device=device)
        self.router = _param(H, E, **mk)
        self.we_gate_up = _param(E, H, 2 * inter, **mk)
        self.we_down = _param(E, inter, H, **mk)
        self.ws_gate_up = self.ws_down = self.ws_route = None
        if shared_inter:
            self.ws_gate_up = _param(H, 2 * shared_inter, **mk)
            self.ws_down = _param(shared_inter, H, **mk)
            if shared_gate:
                self.ws_route = _param(H, 1, **mk)


def layer_kinds(hf, num_layers: int) -> list[str]:
    """"moe" or "dense" for each layer (``mixtral.py:54-68`` of the JAX
    package)."""
    first_dense = getattr(hf, "first_k_dense_replace", 0) or 0
    freq = getattr(hf, "moe_layer_freq", None) or 1
    step = getattr(hf, "decoder_sparse_step", 1) or 1
    mlp_only = set(getattr(hf, "mlp_only_layers", None) or [])
    return ["moe" if (i >= first_dense and i % freq == 0
                      and i not in mlp_only and (i + 1) % step == 0)
            else "dense" for i in range(num_layers)]


class MixtralForCausalLM(LlamaForCausalLM):

    # The shared expert's output is scaled by sigmoid(h @ ws_route)
    # (Qwen2-MoE); DeepSeek V1 adds it ungated.
    shared_gate = True

    def __init__(self, config: ModelConfig,
                 device: torch.device | str = "cpu",
                 quant_config: Optional[QuantizationConfig] = None) -> None:
        if quant_config is not None:
            raise NotImplementedError(
                f"quantization={quant_config.method!r} on the MoE "
                f"architecture {config.architecture!r}: quantized experts "
                "are not ported")
        self._read_moe_config(config.hf_config)
        self.layer_kinds = layer_kinds(config.hf_config, config.num_layers)
        super().__init__(config, device, quant_config)

    def _read_moe_config(self, hf) -> None:
        self.num_experts = getattr(hf, "num_local_experts",
                                   getattr(hf, "num_experts", 8))
        self.top_k = getattr(hf, "num_experts_per_tok", 2)
        self.norm_topk = getattr(hf, "norm_topk_prob", True)
        # The expert width; the dense layers of a mixed stack keep
        # intermediate_size.
        self.moe_intermediate = getattr(hf, "moe_intermediate_size",
                                        hf.intermediate_size)
        self.shared_intermediate = getattr(
            hf, "shared_expert_intermediate_size", 0) or 0

    def _make_layer(self, index: int, device) -> LlamaDecoderLayer:
        if self.layer_kinds[index] == "dense":
            return super()._make_layer(index, device)
        layer = LlamaDecoderLayer(
            self.hidden_size, self.num_heads, self.num_kv_heads,
            self.head_dim, None, self.qkv_bias, self.dtype, device,
            qk_norm=self.qk_norm)
        layer.moe = SparseMoeBlock(
            self.hidden_size, self.num_experts, self.moe_intermediate,
            self.shared_intermediate, self.shared_gate, self.dtype, device)
        return layer

    def _mlp(self, layer: LlamaDecoderLayer, h: torch.Tensor) -> torch.Tensor:
        moe = getattr(layer, "moe", None)
        if moe is None:  # dense layer of a mixed stack
            return super()._mlp(layer, h)
        topi, topw = softmax_topk_routing(h, moe.router, self.top_k,
                                          self.norm_topk)
        out = moe_combine(h, moe.we_gate_up, moe.we_down, topi, topw)
        if moe.ws_gate_up is not None:
            gate, up = (h @ moe.ws_gate_up).chunk(2, dim=-1)
            s = silu_and_mul(gate, up) @ moe.ws_down
            if moe.ws_route is not None:
                s = torch.sigmoid(matmul_f32(h, moe.ws_route)).to(h.dtype) * s
            out = out + s
        return out


class Qwen2MoeForCausalLM(MixtralForCausalLM):
    qkv_bias = True


class Qwen3MoeForCausalLM(Qwen2MoeForCausalLM):
    """Qwen2-MoE routing with Qwen3 attention: no qkv bias, per-head RMS
    q/k norm."""
    qkv_bias = False
    qk_norm = "head"


class OlmoeForCausalLM(MixtralForCausalLM):
    """Mixtral-style MoE with flat RMS q/k norm over the whole
    projection."""
    qk_norm = "flat"


class DeepseekForCausalLM(MixtralForCausalLM):
    """DeepSeek V1 MoE: softmax top-k routing, ``first_k_dense_replace``
    dense layers / ``moe_layer_freq``, and ``n_shared_experts`` always-on
    shared experts (one MLP of n_shared x the expert width) with no
    gate."""
    shared_gate = False

    def _read_moe_config(self, hf) -> None:
        super()._read_moe_config(hf)
        self.num_experts = getattr(hf, "n_routed_experts", self.num_experts)
        n_shared = getattr(hf, "n_shared_experts", 0) or 0
        self.shared_intermediate = n_shared * self.moe_intermediate
