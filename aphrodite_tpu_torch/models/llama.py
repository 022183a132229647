"""Llama-family decoder (Llama 1/2/3, Qwen2 via the bias knob) in PyTorch.

Counterpart of the JAX package's ``models/llama.py``. Weights keep that
package's ``[in, out]`` layout with QKV and gate/up always fused (its
``maybe_merge_params`` form). The MLP is the ``_mlp`` hook, which the
sparse-MoE decoders of ``models/mixtral.py`` override; the optional QK
norms (``qk_norm``: per head after the head reshape, or flat over the
whole projection before it) serve their attention. Two forwards:

- ``forward``: a prefill or mixed wave. Each layer writes its new K/V into
  the paged cache, then attends with the ragged paged attention kernel.
- ``forward_window``: one sub-step of a decode window. The paged cache is
  frozen; each layer writes its K/V into the window tail and attends with
  the window decode kernel.

Quantization (``quant_config``: gptq/awq W4A16, W8A16, fp8, int8 W8A8)
turns each of the four projection weights of a layer into a
``QuantWeight``: buffers holding the quantized leaves, which
``apply_linear`` takes through the format tag. Fusion stays on for quantized leaves, unlike in the JAX
package, which leaves them unfused: groups run along K, so fusing along N
just concatenates ``qweight`` / ``qweight_packed``, ``scales`` and
``zeros`` on their last axis, and every output column is computed as the
unfused projection computes it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from aphrodite_tpu_torch.attention.backend import (paged_attention,
                                                   window_attention,
                                                   write_kv, write_tail)
from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.config import ModelConfig
from aphrodite_tpu_torch.layers.common import ACT2MUL, rms_norm
from aphrodite_tpu_torch.layers.linear import apply_linear, matmul_f32
from aphrodite_tpu_torch.layers.rotary import (RopeConfig, apply_rope,
                                               compute_cos_sin,
                                               compute_inv_freq)
from aphrodite_tpu_torch.quantization.base import (QuantizationConfig,
                                                   runtime_format)
from aphrodite_tpu_torch.quantization.loader import (quantize_weight,
                                                     w4_group, w4_packs)
from aphrodite_tpu_torch.utils import torch_dtype


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class QuantWeight(nn.Module):
    """The quantized leaves of one [K, N] projection, as buffers:
    ``qweight`` int8 [K, N] and ``scales`` fp32 [N] for w8a16 and int8;
    ``qweight`` float8_e4m3fn [K, N] and ``weight_scale`` fp32 [N] for fp8
    and fp8_w8a8 (the JAX package's fp8 leaves, ``models/llama.py:72-73,
    226-229``; a checkpoint's ``weight_scale_block`` and ``input_scale``
    are taken only where a loaded tree gives them);
    ``qweight`` int8 [K, N] (uint4 values) or ``qweight_packed`` uint8
    [K/2, N], with ``scales`` and ``zeros`` fp32 [K/group, N], for w4a16.
    ``loader.weights.realize_int4_leaves`` replaces ``qweight_packed`` with
    ``qweight4`` (signed int4, ``ops.quant_matmul.pack_int4`` bytes [K/2,
    N]) and shifts the zeros by -8. ``input_perm`` (desc_act) is set only
    when a loaded tree carries one."""

    def __init__(self, qcfg: QuantizationConfig, K: int, N: int,
                 device) -> None:
        super().__init__()
        self.shape = (K, N)
        mk = lambda shape, dtype: torch.empty(  # noqa: E731
            shape, dtype=dtype, device=device)
        fmt = runtime_format(qcfg)
        if fmt in ("w8a16", "int8"):
            self.register_buffer("qweight", mk((K, N), torch.int8))
            self.register_buffer("scales", mk((N,), torch.float32))
        elif fmt.startswith("fp8"):
            self.register_buffer("qweight", mk((K, N), torch.float8_e4m3fn))
            self.register_buffer("weight_scale", mk((N,), torch.float32))
            self.register_buffer("weight_scale_block", None)
            self.register_buffer("input_scale", None)
        else:
            group = w4_group(qcfg, K)
            if w4_packs(K, group):
                self.register_buffer("qweight_packed",
                                     mk((K // 2, N), torch.uint8))
            else:
                self.register_buffer("qweight", mk((K, N), torch.int8))
            self.register_buffer("scales", mk((K // group, N), torch.float32))
            self.register_buffer("zeros", mk((K // group, N), torch.float32))
        self.register_buffer("input_perm", None)

    def leaves(self) -> dict[str, torch.Tensor]:
        return {k: v for k, v in self._buffers.items() if v is not None}

    @property
    def device(self) -> torch.device:
        return next(iter(self.leaves().values())).device

    @torch.no_grad()
    def quantize_from(self, w: torch.Tensor,
                      qcfg: QuantizationConfig) -> None:
        """Fill the leaves by quantizing the fp weight w [K, N]."""
        for name, t in quantize_weight(w, qcfg).items():
            getattr(self, name).copy_(t)


class LlamaDecoderLayer(nn.Module):

    def __init__(self, H: int, nq: int, nkv: int, hd: int,
                 inter: Optional[int], qkv_bias: bool, dtype, device,
                 quant_config: Optional[QuantizationConfig] = None,
                 qk_norm: Optional[str] = None) -> None:
        """``inter`` None: no dense MLP (a MoE layer holds its own block).
        ``qk_norm``: "head" adds ``q_norm``/``k_norm`` [hd], "flat" adds
        ``q_norm_flat`` [nq * hd] and ``k_norm_flat`` [nkv * hd]."""
        super().__init__()
        mk = dict(dtype=dtype, device=device)

        def weight(K: int, N: int):
            if quant_config is None:
                return _param(K, N, **mk)
            return QuantWeight(quant_config, K, N, device)

        self.input_norm = _param(H, **mk)
        self.w_qkv = weight(H, (nq + 2 * nkv) * hd)
        self.b_qkv = (_param((nq + 2 * nkv) * hd, **mk) if qkv_bias
                      else None)
        if qk_norm == "head":
            self.q_norm = _param(hd, **mk)
            self.k_norm = _param(hd, **mk)
        elif qk_norm == "flat":
            self.q_norm_flat = _param(nq * hd, **mk)
            self.k_norm_flat = _param(nkv * hd, **mk)
        elif qk_norm is not None:
            raise ValueError(f"unknown qk_norm {qk_norm!r}")
        self.wo = weight(nq * hd, H)
        self.post_norm = _param(H, **mk)
        if inter is not None:
            self.w_gate_up = weight(H, 2 * inter)
            self.w_down = weight(inter, H)


class LlamaForCausalLM(nn.Module):

    # Knobs subclasses flip.
    qkv_bias: bool = False
    tie_embeddings_default: bool = False
    qk_norm: Optional[str] = None  # None | "head" | "flat"
    # The runner may run decode windows through ``forward_window`` (frozen
    # cache + tails); a model without it decodes through ``forward`` with
    # ``md.decode_mode`` (the runner's ``_execute_multi_step``).
    supports_window_decode: bool = True

    def __init__(self, config: ModelConfig,
                 device: torch.device | str = "cpu",
                 quant_config: Optional[QuantizationConfig] = None) -> None:
        super().__init__()
        self.config = config
        self.quant_config = quant_config
        # Format tag of the projection weights; None = full precision.
        self.quant_fmt = (runtime_format(quant_config) if quant_config
                          else None)
        self.dtype = torch_dtype(config.dtype)
        self.hidden_size = config.hidden_size
        self.num_layers = config.num_layers
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_kv_heads
        self.head_dim = config.head_dim
        self.vocab_size = config.vocab_size
        self.rms_eps = config.get("rms_norm_eps", 1e-6)
        self.sliding_window = config.sliding_window
        self.scale = self.head_dim ** -0.5
        act = config.get("hidden_act", "silu")
        if act not in ACT2MUL:
            raise NotImplementedError(f"activation {act!r} is not ported")
        self.act = ACT2MUL[act]
        self.tie_embeddings = config.get("tie_word_embeddings",
                                         self.tie_embeddings_default)
        self.qkv_bias = config.get("attention_bias", self.qkv_bias)
        inv_freq = compute_inv_freq(
            RopeConfig.from_hf_config(config.text_config, self.head_dim))
        self.register_buffer("inv_freq",
                             torch.from_numpy(inv_freq).to(device),
                             persistent=False)
        mk = dict(dtype=self.dtype, device=device)
        self.embed = _param(self.vocab_size, self.hidden_size, **mk)
        self.layers = nn.ModuleList([self._make_layer(i, device)
                                     for i in range(self.num_layers)])
        self.final_norm = _param(self.hidden_size, **mk)
        self.lm_head = (None if self.tie_embeddings else
                        _param(self.hidden_size, self.vocab_size, **mk))

    def _make_layer(self, index: int, device) -> LlamaDecoderLayer:
        """Layer ``index`` with a dense MLP (hook: the MoE decoders give
        their MoE layers a sparse block instead)."""
        return LlamaDecoderLayer(
            self.hidden_size, self.num_heads, self.num_kv_heads,
            self.head_dim, self.config.intermediate_size, self.qkv_bias,
            self.dtype, device, self.quant_config, self.qk_norm)

    # ------------------------------------------------------------------ params
    @torch.no_grad()
    def init_dummy_params(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (N(0, 0.02) drawn in fp32),
        ones for norms, zeros for biases — the JAX package's recipe. A
        quantized projection is drawn in the model's dtype, one at a time,
        and quantized at once (the JAX package's dummy + quantize path), so
        the fp weights of the whole model are never resident. The generator
        must live on the parameters' device."""
        for name, p in self.named_parameters():
            if "norm" in name:
                p.fill_(1.0)
            elif name.rsplit(".", 1)[-1].startswith("b_"):
                p.zero_()
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=generator,
                                           device=p.device))
        for mod in self.modules():
            if isinstance(mod, QuantWeight):
                w = 0.02 * torch.randn(mod.shape, generator=generator,
                                       device=mod.device)
                mod.quantize_from(w.to(self.dtype), self.quant_config)

    # ----------------------------------------------------------------- forward
    def _lin(self, x: torch.Tensor, w, bias=None) -> torch.Tensor:
        if isinstance(w, QuantWeight):
            w = w.leaves()
        return apply_linear(x, w, bias, fmt=self.quant_fmt)

    def _qkv(self, layer: LlamaDecoderLayer, x: torch.Tensor,
             cos: torch.Tensor, sin: torch.Tensor):
        nq, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        T = x.shape[0]
        h = rms_norm(x, layer.input_norm, self.rms_eps)
        qkv = self._lin(h, layer.w_qkv, layer.b_qkv)
        q, k, v = qkv.split([nq * hd, nkv * hd, nkv * hd], dim=-1)
        if self.qk_norm == "flat":  # whole-projection QK norm (OLMoE)
            q = rms_norm(q, layer.q_norm_flat, self.rms_eps)
            k = rms_norm(k, layer.k_norm_flat, self.rms_eps)
        q, k = q.reshape(T, nq, hd), k.reshape(T, nkv, hd)
        if self.qk_norm == "head":  # per-head QK norm (Qwen3 family)
            q = rms_norm(q, layer.q_norm, self.rms_eps)
            k = rms_norm(k, layer.k_norm, self.rms_eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        return q.contiguous(), k, v.reshape(T, nkv, hd)

    def _mlp(self, layer: LlamaDecoderLayer, h: torch.Tensor) -> torch.Tensor:
        gate, up = self._lin(h, layer.w_gate_up).chunk(2, dim=-1)
        return self._lin(self.act(gate, up), layer.w_down)

    def _finish(self, layer: LlamaDecoderLayer, x: torch.Tensor,
                o: torch.Tensor) -> torch.Tensor:
        x = x + self._lin(o.reshape(x.shape[0], -1), layer.wo)
        h = rms_norm(x, layer.post_norm, self.rms_eps)
        return x + self._mlp(layer, h)

    def forward(self, input_ids: torch.Tensor, kv_cache: torch.Tensor,
                md: AttentionMetadata) -> torch.Tensor:
        """Prefill / mixed wave: [T] token ids -> [T, H] final hidden. The
        cache is updated in place."""
        x = self.embed[input_ids]
        cos, sin = compute_cos_sin(md.token_pos, self.inv_freq)
        for li, layer in enumerate(self.layers):
            q, k, v = self._qkv(layer, x, cos, sin)
            write_kv(kv_cache, li, k, v, md.slot_mapping)
            o = paged_attention(q, kv_cache, li, md, self.scale,
                                sliding_window=self.sliding_window)
            x = self._finish(layer, x, o)
        return rms_norm(x, self.final_norm, self.rms_eps)

    def forward_window(self, input_ids: torch.Tensor, kv_cache: torch.Tensor,
                       tail_k: torch.Tensor, tail_v: torch.Tensor,
                       md: AttentionMetadata) -> torch.Tensor:
        """One decode-window sub-step: [R] token ids (one per request, at
        position paged_lens + window_step) -> [R, H]. The paged cache is
        only read; the tails [L, R, kvh, Kw, hd] are updated in place."""
        x = self.embed[input_ids]
        cos, sin = compute_cos_sin(md.token_pos, self.inv_freq)
        for li, layer in enumerate(self.layers):
            q, k, v = self._qkv(layer, x, cos, sin)
            write_tail(tail_k, k, li, md.window_step)
            write_tail(tail_v, v, li, md.window_step)
            o = window_attention(q, kv_cache, tail_k, tail_v, li, md,
                                 self.scale,
                                 sliding_window=self.sliding_window)
            x = self._finish(layer, x, o)
        return rms_norm(x, self.final_norm, self.rms_eps)

    def compute_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """[N, H] -> [N, V] float32 logits, accumulated in fp32."""
        head = self.embed.t() if self.tie_embeddings else self.lm_head
        return matmul_f32(hidden, head)


class Qwen2ForCausalLM(LlamaForCausalLM):
    qkv_bias = True

