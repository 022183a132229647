"""Gemma, Gemma-2 and Gemma-3 (text) decoders in PyTorch.

Counterpart of the JAX package's ``models/gemma.py``. What differs from
Llama: embeddings scaled by sqrt(hidden) in fp32 and cast back, RMSNorm
weights stored as (w - 1) (``offset=1.0``), a GELU-tanh MLP, tied
embeddings; Gemma-2 adds sandwich norms (post-attention, pre- and
post-feedforward), attention and final-logit soft caps,
``query_pre_attn_scalar`` and sliding-window layers alternating with global
ones; Gemma-3 adds a per-head QK norm before rope and rotates its sliding
layers at a local rope base (its global layers take the configured rope
scaling, linear on Gemma-3 4B and larger).

The JAX package's Gemma overrides ``apply``, so it has no window decode
(``supports_window_decode`` is False, ``llama.py:283-310``): its decode
windows run the runner's non-window multi-step path, each sub-step one
``forward`` with ``md.decode_mode`` set, whose attention is the decode
kernel. So this model has no ``forward_window``. Weights keep the Llama
layout with QKV and gate/up fused (``params_from_jax`` fuses the JAX
package's unfused Gemma leaves).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from aphrodite_tpu_torch.attention.backend import paged_attention, write_kv
from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.config import ModelConfig
from aphrodite_tpu_torch.layers.common import ACT2MUL, gelu_and_mul, rms_norm
from aphrodite_tpu_torch.layers.rotary import (RopeConfig, apply_rope,
                                               compute_cos_sin,
                                               compute_inv_freq)
from aphrodite_tpu_torch.models.llama import (LlamaDecoderLayer,
                                              LlamaForCausalLM, _param)
from aphrodite_tpu_torch.quantization.base import QuantizationConfig


class GemmaDecoderLayer(LlamaDecoderLayer):
    """A Llama layer plus, with ``sandwich``, Gemma-2's post-attention and
    pre-/post-feedforward norms."""

    def __init__(self, H: int, nq: int, nkv: int, hd: int, inter: int,
                 dtype, device, sandwich: bool,
                 qk_norm: Optional[str]) -> None:
        super().__init__(H, nq, nkv, hd, inter, False, dtype, device,
                         qk_norm=qk_norm)
        if sandwich:
            self.post_attn_norm = _param(H, dtype=dtype, device=device)
            self.pre_ffw_norm = _param(H, dtype=dtype, device=device)
            self.post_ffw_norm = _param(H, dtype=dtype, device=device)


class GemmaForCausalLM(LlamaForCausalLM):
    tie_embeddings_default = True
    supports_window_decode = False
    forward_window = None  # decode sub-steps run ``forward`` (decode_mode)
    # Knobs Gemma-2 and Gemma-3 flip.
    sandwich_norms: bool = False
    per_layer_sliding: bool = False

    def __init__(self, config: ModelConfig,
                 device: torch.device | str = "cpu",
                 quant_config: Optional[QuantizationConfig] = None) -> None:
        if quant_config is not None:
            raise NotImplementedError(
                "quantized Gemma-family serving is not ported")
        super().__init__(config, device)
        self.embed_scale = math.sqrt(self.hidden_size)
        act = config.get("hidden_activation",
                         config.get("hidden_act", "gelu_pytorch_tanh"))
        self.act = ACT2MUL.get(act, gelu_and_mul)
        qpre = config.get("query_pre_attn_scalar")
        if qpre is not None:
            self.scale = qpre ** -0.5
        self.attn_soft_cap = config.get("attn_logit_softcapping")
        self.final_soft_cap = config.get("final_logit_softcapping")
        # Per-layer sliding flags (Gemma-2/3): HF layer_types, else the
        # even-layers-slide convention (``gemma.py:158-172``). None: every
        # layer takes the configured window, if any.
        self.is_sliding: Optional[list[bool]] = None
        if self.per_layer_sliding:
            types = config.get("layer_types")
            self.is_sliding = ([t == "sliding_attention" for t in types]
                               if types else
                               [i % 2 == 0 for i in range(self.num_layers)])
        # Gemma-3's local rope frequencies; None: one rope for all layers.
        self.register_buffer("inv_freq_local", None, persistent=False)

    def _make_layer(self, index: int, device) -> GemmaDecoderLayer:
        return GemmaDecoderLayer(
            self.hidden_size, self.num_heads, self.num_kv_heads,
            self.head_dim, self.config.intermediate_size, self.dtype, device,
            self.sandwich_norms, self.qk_norm)

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, w, self.rms_eps, offset=1.0)

    def forward(self, input_ids: torch.Tensor, kv_cache: torch.Tensor,
                md: AttentionMetadata) -> torch.Tensor:
        """Prefill / mixed wave, or one decode sub-step (``md.decode_mode``):
        [T] token ids -> [T, H] final hidden. The cache is updated in
        place."""
        nq, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        x = self.embed[input_ids]
        x = (x.float() * self.embed_scale).to(x.dtype)
        T = x.shape[0]
        rope = compute_cos_sin(md.token_pos, self.inv_freq)
        rope_local = (rope if self.inv_freq_local is None else
                      compute_cos_sin(md.token_pos, self.inv_freq_local))
        for li, layer in enumerate(self.layers):
            sliding = self.is_sliding is None or self.is_sliding[li]
            h = self._norm(x, layer.input_norm)
            q, k, v = self._lin(h, layer.w_qkv).split(
                [nq * hd, nkv * hd, nkv * hd], dim=-1)
            q, k = q.reshape(T, nq, hd), k.reshape(T, nkv, hd)
            if self.qk_norm == "head":  # Gemma-3, before rope
                q = self._norm(q, layer.q_norm)
                k = self._norm(k, layer.k_norm)
            cos, sin = rope_local if sliding else rope
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            write_kv(kv_cache, li, k, v.reshape(T, nkv, hd), md.slot_mapping)
            o = paged_attention(
                q, kv_cache, li, md, self.scale,
                sliding_window=self.sliding_window if sliding else None,
                logits_soft_cap=self.attn_soft_cap)
            o = self._lin(o.reshape(T, nq * hd), layer.wo)
            if self.sandwich_norms:
                o = self._norm(o, layer.post_attn_norm)
            x = x + o
            h = self._norm(x, layer.pre_ffw_norm if self.sandwich_norms
                           else layer.post_norm)
            m = self._mlp(layer, h)
            if self.sandwich_norms:
                m = self._norm(m, layer.post_ffw_norm)
            x = x + m
        return self._norm(x, self.final_norm)

    def compute_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """[N, H] -> [N, V] float32 logits, with the final soft cap."""
        logits = super().compute_logits(hidden)
        if self.final_soft_cap:
            logits = self.final_soft_cap * torch.tanh(
                logits / self.final_soft_cap)
        return logits


class Gemma2ForCausalLM(GemmaForCausalLM):
    sandwich_norms = True
    per_layer_sliding = True


class Gemma3ForCausalLM(Gemma2ForCausalLM):
    """Gemma-3 text: Gemma-2's layers plus a per-head QK norm; sliding
    layers rotate at ``rope_local_base_freq`` with no scaling, global
    layers at the configured base and scaling (``gemma.py:198-215``)."""
    qk_norm = "head"

    def __init__(self, config: ModelConfig,
                 device: torch.device | str = "cpu",
                 quant_config: Optional[QuantizationConfig] = None) -> None:
        super().__init__(config, device, quant_config)
        local = RopeConfig(
            head_dim=self.head_dim, rotary_dim=self.head_dim,
            base=config.get("rope_local_base_freq", 10000.0), scaling=None)
        self.inv_freq_local = torch.from_numpy(
            compute_inv_freq(local)).to(device)
