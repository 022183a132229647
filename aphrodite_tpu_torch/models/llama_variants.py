"""The knob-driven decoder of the JAX package's ``models/llama_variants.py``
(``FlexibleDecoder``, ``:57-547``) in PyTorch, with its ALiBi families:
BLOOM, MPT, Falcon (all three generations) and Baichuan / Baichuan2.

One class serves many architectures through class-level knobs that each
family's ``_setup`` sets from the HF config, as in the JAX package:

- the residual stream: LayerNorm (with or without bias) or RMSNorm,
  sequential pre-norm blocks or parallel attention + MLP branches (one
  shared norm or two), an optional LayerNorm after the embedding and a
  final norm;
- attention: rotary (full head_dim, rotate-half) or ALiBi positions, QKV
  and output biases, QKV clamping (MPT), a softmax scale override;
- the MLP: gated (``ACT2MUL``) or dense (``DENSE_ACTS``), with or without
  biases; tied or separate LM head.

ALiBi slopes ride every attention call: the ragged kernel of the waves and
the decode kernel of the multi-step path, which these models take (the JAX
package gives them no window decode, ``worker/runner.py:201-202``). Every
knob the JAX class has but the families here do not use (QK norms,
sandwich and post-block norms, ``ln1p`` / ``noaffine`` norms, learned
positions, block-sparse attention, per-layer sliding flags, MoE MLPs, the
multipliers, the attention soft cap, an LM-head bias, partial and
interleaved rope) keeps its default and raises ``NotImplementedError`` when
a subclass sets it: they come with the rest of the registry (ROADMAP A13).

Weights keep the JAX package's ``[in, out]`` layout and its leaf names,
with Q/K/V (and a gated MLP's gate/up) fused along N as the port's Llama
does; ``loader.weights.params_from_jax`` fuses a JAX tree's leaves. The
checkpoint importers (the fused-QKV splitters ``_special_weight`` and
Baichuan2's NormHead, applied only by the JAX ``load_weights``) wait for
checkpoint loading (ROADMAP A4); quantization is not ported here, and the
port has no LoRA path.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from aphrodite_tpu_torch.attention.backend import (alibi_slopes,
                                                   paged_attention, write_kv)
from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.config import ModelConfig
from aphrodite_tpu_torch.layers.common import (ACT2MUL, DENSE_ACTS,
                                               layer_norm, rms_norm)
from aphrodite_tpu_torch.layers.linear import apply_linear, matmul_f32
from aphrodite_tpu_torch.layers.rotary import (RopeConfig, apply_rope,
                                               compute_cos_sin,
                                               compute_inv_freq)
from aphrodite_tpu_torch.models.llama import _param
from aphrodite_tpu_torch.quantization.base import QuantizationConfig
from aphrodite_tpu_torch.utils import torch_dtype


class FlexibleLayer(nn.Module):
    """One decoder layer's leaves, named as the JAX package's per-layer
    keys (Q/K/V fused as ``w_qkv``/``b_qkv``, a gated MLP's gate/up as
    ``w_gate_up``/``b_gate_up``)."""

    def __init__(self, shapes: dict[str, tuple], dtype, device) -> None:
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, _param(*shape, dtype=dtype, device=device))


class FlexibleDecoder(nn.Module):
    """Knob-driven decoder; each family's ``_setup`` sets the knobs."""

    # --- residual / norm structure (served)
    norm_kind: str = "ln"          # ln | rms
    norm_bias: bool = True
    parallel_residual: bool = False
    shared_ln: bool = True         # parallel branches read one norm
    final_norm: bool = True
    embed_norm: bool = False       # LayerNorm right after the embedding
    # --- attention (served)
    positions: str = "rope"        # rope | alibi
    attn_bias: bool = False
    attn_out_bias: Optional[bool] = None   # None -> attn_bias
    clip_qkv: Optional[float] = None
    # --- MLP (served)
    mlp_kind: str = "gated"        # gated | dense
    mlp_bias: bool = False
    tie_default: bool = False
    # --- knobs of the JAX class not ported yet (A13): each raises when a
    # subclass moves it off this default.
    block_norm: str = "pre"
    qk_norm: Optional[str] = None
    sandwich_norm: bool = False
    rope_interleaved: bool = False
    blocksparse: Optional[tuple] = None
    sliding_flags: Optional[list] = None   # Cohere2's per-layer is_sliding
    attn_soft_cap: Optional[float] = None
    attn_output_multiplier: float = 1.0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_multiplier: float = 1.0
    lm_head_bias: bool = False
    # --- what the runner reads
    supports_window_decode: bool = False
    forward_window = None  # decode sub-steps run ``forward`` (decode_mode)

    def __init__(self, config: ModelConfig,
                 device: torch.device | str = "cpu",
                 quant_config: Optional[QuantizationConfig] = None) -> None:
        super().__init__()
        if quant_config is not None:
            raise NotImplementedError(
                f"quantized {type(self).__name__} serving is not ported")
        self.config = config
        self.dtype = torch_dtype(config.dtype)
        self.hidden_size = config.hidden_size
        self.num_layers = config.num_layers
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_kv_heads
        self.head_dim = config.head_dim
        self.vocab_size = config.vocab_size
        self.sliding_window = config.sliding_window
        self.scale = self.head_dim ** -0.5
        self.intermediate_size = (config.get("intermediate_size")
                                  or config.get("ffn_dim")
                                  or 4 * self.hidden_size)
        self.tie_embeddings = config.get("tie_word_embeddings",
                                         self.tie_default)
        self._alibi: Optional[torch.Tensor] = None
        self._setup(config)
        self._check_knobs()
        if self.attn_out_bias is None:
            self.attn_out_bias = self.attn_bias
        self.register_buffer("alibi", None, persistent=False)
        self.register_buffer("inv_freq", None, persistent=False)
        if self.positions == "alibi":
            slopes = (self._alibi if self._alibi is not None
                      else alibi_slopes(self.num_heads))
            self.alibi = slopes.to(device)
        else:
            self.inv_freq = torch.from_numpy(
                compute_inv_freq(self._rope_config(config))).to(device)
        mk = dict(dtype=self.dtype, device=device)
        H = self.hidden_size
        self.embed = _param(self.vocab_size, H, **mk)
        self.embed_ln_w = _param(H, **mk) if self.embed_norm else None
        self.embed_ln_b = (_param(H, **mk)
                           if self.embed_norm and self.norm_bias else None)
        self.layers = nn.ModuleList([
            FlexibleLayer(self._layer_shapes(), self.dtype, device)
            for _ in range(self.num_layers)])
        self.final_norm_w = _param(H, **mk) if self.final_norm else None
        self.final_norm_b = (_param(H, **mk)
                             if self.final_norm and self.norm_bias else None)
        self.lm_head = (None if self.tie_embeddings else
                        _param(H, self.vocab_size, **mk))

    def _setup(self, config: ModelConfig) -> None:  # pragma: no cover
        raise NotImplementedError

    def _check_knobs(self) -> None:
        """Raise on every knob whose JAX code path is not ported yet."""
        off = {
            "norm_kind": self.norm_kind not in ("ln", "rms"),
            "block_norm": self.block_norm != "pre",
            "qk_norm": self.qk_norm is not None,
            "sandwich_norm": self.sandwich_norm,
            "positions": self.positions not in ("rope", "alibi"),
            "rope_interleaved": self.rope_interleaved,
            "blocksparse": self.blocksparse is not None,
            "sliding_flags": self.sliding_flags is not None,
            "mlp_kind": self.mlp_kind not in ("gated", "dense"),
            "attn_soft_cap": self.attn_soft_cap is not None,
            "lm_head_bias": self.lm_head_bias,
            "multipliers": (self.attn_output_multiplier,
                            self.embedding_multiplier,
                            self.residual_multiplier,
                            self.logits_multiplier) != (1.0,) * 4,
        }
        bad = sorted(k for k, v in off.items() if v)
        if bad:
            raise NotImplementedError(
                f"{type(self).__name__}: FlexibleDecoder knobs {bad} are not "
                "ported yet (ROADMAP A13)")

    def _rope_config(self, config: ModelConfig) -> RopeConfig:
        """The JAX class's rope (``llama_variants.py:128-141``); partial
        rotary raises (A13)."""
        pct = config.get("partial_rotary_factor",
                         config.get("rotary_pct", 1.0))
        rotary_dim = (config.get("rotary_dim")
                      or int(self.head_dim * pct))
        if rotary_dim != self.head_dim:
            raise NotImplementedError(
                f"{type(self).__name__}: partial rotary ({rotary_dim} of "
                f"{self.head_dim} dims) is not ported yet (ROADMAP A13)")
        scaling = config.get("rope_scaling")
        return RopeConfig(
            head_dim=self.head_dim, rotary_dim=rotary_dim,
            base=config.get("rope_theta",
                            config.get("rotary_emb_base", 10000.0)),
            scaling=dict(scaling) if scaling is not None else None)

    def _layer_shapes(self) -> dict[str, tuple]:
        """A layer's leaves (``llama_variants.py:170-222``, fused)."""
        H, nq, nkv, hd, inter = (self.hidden_size, self.num_heads,
                                 self.num_kv_heads, self.head_dim,
                                 self.intermediate_size)
        shapes: dict[str, tuple] = {"ln1_w": (H,)}
        if self.norm_bias:
            shapes["ln1_b"] = (H,)
        if not (self.parallel_residual and self.shared_ln):
            shapes["ln2_w"] = (H,)
            if self.norm_bias:
                shapes["ln2_b"] = (H,)
        shapes.update(w_qkv=(H, (nq + 2 * nkv) * hd), wo=(nq * hd, H))
        if self.attn_bias:
            shapes["b_qkv"] = ((nq + 2 * nkv) * hd,)
        if self.attn_out_bias:
            shapes["bo"] = (H,)
        if self.mlp_kind == "gated":
            shapes.update(w_gate_up=(H, 2 * inter), w_down=(inter, H))
            if self.mlp_bias:
                shapes.update(b_gate_up=(2 * inter,), b_down=(H,))
        else:
            shapes.update(fc1_w=(H, inter), fc2_w=(inter, H))
            if self.mlp_bias:
                shapes.update(fc1_b=(inter,), fc2_b=(H,))
        return shapes

    # ------------------------------------------------------------------ params
    @torch.no_grad()
    def init_dummy_params(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (N(0, 0.02) drawn in fp32),
        ones for norm scales, zeros for biases: the JAX package's recipe.
        The generator must live on the parameters' device."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("b") or leaf.endswith("_b"):
                p.zero_()
            elif "ln" in leaf or "norm" in leaf:
                p.fill_(1.0)
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=generator,
                                           device=p.device))

    # ----------------------------------------------------------------- forward
    def _norm(self, x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor]) -> torch.Tensor:
        if self.norm_kind == "rms":
            return rms_norm(x, w, self.norm_eps)
        return layer_norm(x, w, b, self.norm_eps)

    def _attn(self, layer: FlexibleLayer, li: int, h: torch.Tensor,
              kv_cache: torch.Tensor, md: AttentionMetadata,
              rope: Optional[tuple]) -> torch.Tensor:
        nq, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        T = h.shape[0]
        qkv = apply_linear(h, layer.w_qkv, getattr(layer, "b_qkv", None))
        if self.clip_qkv is not None:
            qkv = qkv.clamp(-self.clip_qkv, self.clip_qkv)
        q, k, v = qkv.split([nq * hd, nkv * hd, nkv * hd], dim=-1)
        q, k = q.reshape(T, nq, hd), k.reshape(T, nkv, hd)
        if rope is not None:
            q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        write_kv(kv_cache, li, k, v.reshape(T, nkv, hd), md.slot_mapping)
        o = paged_attention(q.contiguous(), kv_cache, li, md, self.scale,
                            sliding_window=self.sliding_window,
                            alibi=self.alibi)
        return apply_linear(o.reshape(T, nq * hd), layer.wo,
                            getattr(layer, "bo", None))

    def _mlp(self, layer: FlexibleLayer, h: torch.Tensor) -> torch.Tensor:
        if self.mlp_kind == "gated":
            gate, up = apply_linear(
                h, layer.w_gate_up, getattr(layer, "b_gate_up", None)
            ).chunk(2, dim=-1)
            return apply_linear(self.act(gate, up), layer.w_down,
                                getattr(layer, "b_down", None))
        m = self.act(apply_linear(h, layer.fc1_w,
                                  getattr(layer, "fc1_b", None)))
        return apply_linear(m, layer.fc2_w, getattr(layer, "fc2_b", None))

    def forward(self, input_ids: torch.Tensor, kv_cache: torch.Tensor,
                md: AttentionMetadata) -> torch.Tensor:
        """Prefill / mixed wave, or one decode sub-step (``md.decode_mode``):
        [T] token ids -> [T, H] final hidden (``llama_variants.py:387-532``).
        The cache is updated in place."""
        x = self.embed[input_ids]
        if self.embed_norm:
            x = self._norm(x, self.embed_ln_w, self.embed_ln_b)
        rope = (None if self.inv_freq is None
                else compute_cos_sin(md.token_pos, self.inv_freq))
        for li, layer in enumerate(self.layers):
            h1 = self._norm(x, layer.ln1_w, getattr(layer, "ln1_b", None))
            a = self._attn(layer, li, h1, kv_cache, md, rope)
            if self.parallel_residual:
                h2 = h1 if self.shared_ln else self._norm(
                    x, layer.ln2_w, getattr(layer, "ln2_b", None))
                x = x + a + self._mlp(layer, h2)
            else:
                x = x + a
                h2 = self._norm(x, layer.ln2_w, getattr(layer, "ln2_b", None))
                x = x + self._mlp(layer, h2)
        if self.final_norm:
            x = self._norm(x, self.final_norm_w, self.final_norm_b)
        return x

    def compute_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """[N, H] -> [N, V] float32 logits, accumulated in fp32."""
        head = self.embed.t() if self.tie_embeddings else self.lm_head
        return matmul_f32(hidden, head)


class BloomForCausalLM(FlexibleDecoder):
    """HF 'BloomForCausalLM' (``llama_variants.py:965-1020``): ALiBi, a
    LayerNorm after the embedding, dense gelu-tanh MLP, biases everywhere,
    tied embeddings."""
    positions = "alibi"
    embed_norm = True
    tie_default = True

    def _setup(self, config: ModelConfig) -> None:
        self.norm_kind = "ln"
        self.norm_eps = config.get("layer_norm_epsilon", 1e-5)
        self.mlp_kind = "dense"
        self.act = DENSE_ACTS["gelu_pytorch_tanh"]  # BloomGelu
        self.attn_bias = True
        self.attn_out_bias = True
        self.mlp_bias = True


class MPTForCausalLM(FlexibleDecoder):
    """HF 'MPTForCausalLM' / 'MptForCausalLM' (``:1023-1082``): ALiBi with
    MPT's own slope interpolation, bias-free LayerNorms and Linears, an
    optional QKV clamp and softmax scale, dense exact-gelu MLP
    (``expansion_ratio``), tied embeddings."""
    positions = "alibi"
    tie_default = True

    def _setup(self, config: ModelConfig) -> None:
        self.norm_kind = "ln"
        self.norm_bias = False  # HF MPT nulls LN biases unconditionally
        self.norm_eps = config.get("layer_norm_epsilon", 1e-5)
        self.mlp_kind = "dense"
        self.act = DENSE_ACTS["gelu"]
        self.intermediate_size = int(config.get("expansion_ratio", 4)
                                     * self.hidden_size)
        ac = config.get("attn_config")
        if ac is None:
            get = lambda k, d=None: d  # noqa: E731
        elif isinstance(ac, dict):
            get = ac.get
        else:
            get = lambda k, d=None: getattr(ac, k, d)  # noqa: E731
        self.clip_qkv = get("clip_qkv", None)
        if get("softmax_scale", None):
            self.scale = get("softmax_scale")
        self._alibi = self.mpt_slopes(self.num_heads,
                                      get("alibi_bias_max", 8))

    @staticmethod
    def mpt_slopes(n: int, bias_max: float) -> torch.Tensor:
        """HF ``build_mpt_alibi_tensor``'s slopes [n] fp32, computed in
        float64 as ``_mpt_slopes`` (``:1065-1073``): 1 / 2**(bias_max * i /
        np2) over the next power of two np2, interleaved (odd steps, then
        even) when n is not one."""
        np2 = 2 ** math.ceil(math.log2(n))
        base = np.arange(1, np2 + 1, dtype=np.float64) * (bias_max / np2)
        slopes = 1.0 / np.power(2.0, base)
        if np2 != n:
            slopes = np.concatenate([slopes[1::2], slopes[::2]])[:n]
        return torch.from_numpy(slopes).float()


class FalconForCausalLM(FlexibleDecoder):
    """HF 'FalconForCausalLM' / 'RWForCausalLM' (``:1085-1185``), in its
    three generations, chosen from the config as HF's decoder layer does:
    the new architecture (2 LNs: parallel attention and MLP on separate
    norms, GQA); ``parallel_attn`` (falcon-7b: parallel on one shared norm,
    MQA, rope); neither (falcon-rw: sequential pre-norm, ALiBi when
    ``alibi``)."""

    def _setup(self, config: ModelConfig) -> None:
        self.norm_kind = "ln"
        self.norm_eps = config.get("layer_norm_epsilon", 1e-5)
        self.mlp_kind = "dense"
        self.act = DENSE_ACTS[config.get("activation", "gelu")]
        self.intermediate_size = (config.get("ffn_hidden_size")
                                  or 4 * self.hidden_size)
        bias = config.get("bias", False)
        self.attn_bias = self.attn_out_bias = self.mlp_bias = bias
        if config.get("alibi", False):
            self.positions = "alibi"
        num_ln = config.get("num_ln_in_parallel_attn")
        new_arch = config.get("new_decoder_architecture", False)
        if num_ln is None and new_arch:
            num_ln = 2
        if new_arch and num_ln == 2:
            self.parallel_residual, self.shared_ln = True, False
        elif config.get("parallel_attn", True):
            self.parallel_residual, self.shared_ln = True, True


class BaichuanForCausalLM(FlexibleDecoder):
    """'BaichuanForCausalLM' (Baichuan / Baichuan2, ``:1188-1230``): a
    Llama body (RMSNorm, gated SwiGLU, no biases); rope at hidden 4096
    (the 7B models), ALiBi otherwise (13B)."""
    rope_when_hidden = 4096

    def _setup(self, config: ModelConfig) -> None:
        self.norm_kind = "rms"
        self.norm_bias = False
        self.norm_eps = config.get("rms_norm_eps", 1e-6)
        self.act = ACT2MUL[config.get("hidden_act", "silu")]
        if self.hidden_size != self.rope_when_hidden:
            self.positions = "alibi"


class BaiChuanForCausalLM(BaichuanForCausalLM):
    """'BaiChuanForCausalLM' (``:1233-1240``): the original baichuan-7B
    export, always rope."""

    def _setup(self, config: ModelConfig) -> None:
        super()._setup(config)
        self.positions = "rope"
