"""DeepSeek V2 / V3: multi-head latent attention (MLA) and DeepSeek-MoE.

Counterpart of the JAX package's ``models/deepseek.py``, which runs MLA as
MQA over one latent head: queries are projected into the KV latent space
(``q_lat = q_nope @ W_UK``, the absorbed up-projection) and each token
caches K = [c_kv, k_pe] and V = [c_kv, 0], one KV head of kv_lora_rank +
qk_rope_head_dim lanes (512 + 64 = 576 for every published model), so
both attention kernels run at that geometry (their MLA instances in bf16 and
fp16, ``csrc/mla_attention.cuh``). The attention output is the latent context;
``W_UV`` and ``wo`` unproject it. The two absorbed products sum in fp32 and
round once to the model's dtype, as the reference's einsums with
``preferred_element_type=f32`` do (``layers.linear.bmm_f32``). The softmax
scale is qk_head_dim^-0.5, times DeepSeek-YaRN's mscale_all_dim correction
squared, never head_dim's.

The rope (qk_rope_head_dim lanes of q and k) is pair-interleaved, and a
checkpoint's ``rope_scaling`` is read as ``deepseek_yarn``. The first
``first_k_dense_replace`` layers (and those off ``moe_layer_freq``) have a
dense MLP, the rest a DeepSeek-MoE block: routed experts through
``moe_common.moe_combine`` under V2's softmax routing (greedy or
group-limited) or V3's sigmoid routing with its score correction, plus
ungated shared experts.

Weights keep the JAX package's ``[in, out]`` layout with gate/up fused,
but the absorbed einsums' weights are stored for batched products over the
heads: ``w_uk`` [nq, nope, R] and ``w_uv`` [nq, R, v] (the JAX [R, nq, d]
permuted; ``loader.weights.params_from_jax`` does it). Quantization is not
ported for these models (quantized experts, ROADMAP A10): an engine built
with ``quantization=`` raises. The JAX package's LoRA and pipeline
parallelism, which its DeepSeek refuses too, have no counterpart in the
port. ``MiniCPM3ForCausalLM`` waits for longrope (ROADMAP A10).
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
from aphrodite_tpu_torch.layers.linear import bmm_f32, matmul_f32
from aphrodite_tpu_torch.layers.rotary import (RopeConfig,
                                               apply_rope_interleaved,
                                               compute_cos_sin,
                                               compute_inv_freq,
                                               deepseek_yarn_mscale)
from aphrodite_tpu_torch.models.llama import _param
from aphrodite_tpu_torch.models.mixtral import SparseMoeBlock
from aphrodite_tpu_torch.models.moe_common import (deepseek_routing,
                                                   moe_combine)
from aphrodite_tpu_torch.quantization.base import QuantizationConfig
from aphrodite_tpu_torch.utils import torch_dtype


class DeepseekLayer(nn.Module):
    """One decoder layer: MLA attention leaves (``wq`` or ``wq_a`` /
    ``q_a_norm`` / ``wq_b``, ``wkv_a``, ``kv_a_norm``, ``w_uk``, ``w_uv``,
    ``wo``), the two norms, and a dense MLP (``w_gate_up``, ``w_down``) or
    a ``moe`` block."""

    def __init__(self, m: "DeepseekV2ForCausalLM", kind: str,
                 device) -> None:
        super().__init__()
        mk = dict(dtype=m.dtype, device=device)
        H, nq, R = m.hidden_size, m.num_heads, m.kv_lora_rank
        self.input_norm = _param(H, **mk)
        if m.q_lora_rank is None:
            self.wq = _param(H, nq * m.qk_head_dim, **mk)
        else:
            self.wq_a = _param(H, m.q_lora_rank, **mk)
            self.q_a_norm = _param(m.q_lora_rank, **mk)
            self.wq_b = _param(m.q_lora_rank, nq * m.qk_head_dim, **mk)
        self.wkv_a = _param(H, R + m.qk_rope_head_dim, **mk)
        self.kv_a_norm = _param(R, **mk)
        self.w_uk = _param(nq, m.qk_nope_head_dim, R, **mk)
        self.w_uv = _param(nq, R, m.v_head_dim, **mk)
        self.wo = _param(nq * m.v_head_dim, H, **mk)
        self.post_norm = _param(H, **mk)
        if kind == "dense":
            self.w_gate_up = _param(H, 2 * m.intermediate_size, **mk)
            self.w_down = _param(m.intermediate_size, H, **mk)
        else:
            self.moe = SparseMoeBlock(H, m.num_experts, m.moe_intermediate,
                                      m.n_shared * m.moe_intermediate,
                                      False, m.dtype, device)
            # V3's e_score correction, fp32 as in the JAX tree.
            self.moe.router_bias = (
                _param(m.num_experts, dtype=torch.float32, device=device)
                if m.router_style == "v3" else None)


class DeepseekV2ForCausalLM(nn.Module):
    """Also DeepSeek-V2-Lite (no q_lora_rank, greedy routing)."""

    router_style = "v2"
    # Decode windows run ``forward_window`` (latent K/V rows ride the
    # tails), as the JAX model's ``_window_forward_ok``.
    supports_window_decode = True

    def __init__(self, config: ModelConfig,
                 device: torch.device | str = "cpu",
                 quant_config: Optional[QuantizationConfig] = None) -> None:
        if quant_config is not None:
            raise NotImplementedError(
                f"quantization={quant_config.method!r} on "
                f"{config.architecture!r}: quantized DeepSeek (MLA "
                "projections, experts) is not ported (ROADMAP A10)")
        super().__init__()
        hf = config.hf_config
        self.config = config
        self.dtype = torch_dtype(config.dtype)
        self.hidden_size = config.hidden_size
        self.num_layers = config.num_layers
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_kv_heads   # 1: the latent head
        self.head_dim = config.head_dim           # kv_lora_rank + rope
        self.vocab_size = config.vocab_size
        self.intermediate_size = config.intermediate_size
        self.rms_eps = config.get("rms_norm_eps", 1e-6)
        self.sliding_window = None
        act = config.get("hidden_act", "silu")
        if act != "silu":  # the experts' combine is SwiGLU
            raise NotImplementedError(f"activation {act!r} is not ported")
        self.act = ACT2MUL[act]
        self.tie_embeddings = config.get("tie_word_embeddings", False)
        self.q_lora_rank = config.get("q_lora_rank")
        self.kv_lora_rank = hf.kv_lora_rank
        self.qk_nope_head_dim = hf.qk_nope_head_dim
        self.qk_rope_head_dim = hf.qk_rope_head_dim
        self.qk_head_dim = self.qk_nope_head_dim + self.qk_rope_head_dim
        self.v_head_dim = hf.v_head_dim

        # Softmax scale: qk_head_dim^-0.5 times deepseek-yarn's
        # mscale_all_dim^2 (``deepseek.py:83-103`` of the JAX package).
        self.scale = self.qk_head_dim ** -0.5
        scaling = config.get("rope_scaling")
        if scaling:
            scaling = dict(scaling)
            scaling["rope_type"] = "deepseek_yarn"
            m = deepseek_yarn_mscale(scaling.get("factor", 1.0),
                                     float(scaling.get("mscale_all_dim", 0.)))
            self.scale = self.scale * m * m
        inv_freq, self.rope_mscale = compute_inv_freq(RopeConfig(
            head_dim=self.qk_rope_head_dim,
            rotary_dim=self.qk_rope_head_dim,
            base=config.get("rope_theta", 10000.0), scaling=scaling or None,
            max_position=config.get("max_position_embeddings", 2048)),
            with_mscale=True)
        self.register_buffer("inv_freq",
                             torch.from_numpy(inv_freq).to(device),
                             persistent=False)

        # MoE geometry (``deepseek.py:105-125``).
        self.num_experts = config.get("n_routed_experts")
        self.top_k = config.get("num_experts_per_tok")
        self.moe_intermediate = config.get("moe_intermediate_size")
        self.n_shared = config.get("n_shared_experts") or 0
        self.n_group = config.get("n_group")
        self.topk_group = config.get("topk_group")
        self.norm_topk = config.get("norm_topk_prob", False)
        self.routed_scaling = config.get("routed_scaling_factor", 1.0)
        first_dense = config.get("first_k_dense_replace",
                                 self.num_layers if self.num_experts is None
                                 else 0)
        freq = config.get("moe_layer_freq") or 1
        self.layer_kinds = [
            "moe" if (self.num_experts is not None and i >= first_dense
                      and i % freq == 0) else "dense"
            for i in range(self.num_layers)]

        mk = dict(dtype=self.dtype, device=device)
        self.embed = _param(self.vocab_size, self.hidden_size, **mk)
        self.layers = nn.ModuleList([DeepseekLayer(self, kind, device)
                                     for kind in self.layer_kinds])
        self.final_norm = _param(self.hidden_size, **mk)
        self.lm_head = (None if self.tie_embeddings else
                        _param(self.hidden_size, self.vocab_size, **mk))

    @torch.no_grad()
    def init_dummy_params(self, generator: torch.Generator) -> None:
        """The JAX package's dummy recipe: N(0, 0.02) drawn in fp32, ones
        for norms, zeros for V3's score correction."""
        for name, p in self.named_parameters():
            if "norm" in name:
                p.fill_(1.0)
            elif name.endswith("router_bias"):
                p.zero_()
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=generator,
                                           device=p.device))

    # ----------------------------------------------------------------- forward
    def _qkv(self, layer: DeepseekLayer, x: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor):
        """(q [T, nq, 576], k [T, 1, 576], v [T, 1, 576]) of the latent MQA
        (``deepseek.py:375-402``): q = [q_nope W_UK, rope(q_pe)], k =
        [c_kv, rope(k_pe)], v = [c_kv, 0]."""
        T = x.shape[0]
        nq, R, nope = self.num_heads, self.kv_lora_rank, self.qk_nope_head_dim
        h = rms_norm(x, layer.input_norm, self.rms_eps)
        if self.q_lora_rank is None:
            q = h @ layer.wq
        else:
            q = rms_norm(h @ layer.wq_a, layer.q_a_norm, self.rms_eps)
            q = q @ layer.wq_b
        q = q.view(T, nq, self.qk_head_dim)
        q_pe = apply_rope_interleaved(q[..., nope:], cos, sin)
        kv_a = h @ layer.wkv_a
        ckv = rms_norm(kv_a[:, :R], layer.kv_a_norm, self.rms_eps)
        k_pe = apply_rope_interleaved(kv_a[:, None, R:], cos, sin)
        # The absorbed W_UK, one product a head (fp32 sums, rounded once).
        q_lat = bmm_f32(q[..., :nope].transpose(0, 1),
                        layer.w_uk).to(x.dtype).transpose(0, 1)
        q_cat = torch.cat([q_lat, q_pe], dim=-1)
        k_cat = torch.cat([ckv[:, None], k_pe], dim=-1)
        v_cat = torch.cat([ckv[:, None], torch.zeros_like(k_pe)], dim=-1)
        return q_cat, k_cat, v_cat

    def _mlp(self, layer: DeepseekLayer, h: torch.Tensor) -> torch.Tensor:
        moe = getattr(layer, "moe", None)
        if moe is None:
            gate, up = (h @ layer.w_gate_up).chunk(2, dim=-1)
            return self.act(gate, up) @ layer.w_down
        topi, topw = deepseek_routing(
            h, moe.router, self.top_k, self.router_style, self.n_group,
            self.topk_group, self.norm_topk, self.routed_scaling,
            moe.router_bias)
        out = moe_combine(h, moe.we_gate_up, moe.we_down, topi, topw)
        if moe.ws_gate_up is not None:
            gate, up = (h @ moe.ws_gate_up).chunk(2, dim=-1)
            out = out + self.act(gate, up) @ moe.ws_down
        return out

    def _finish(self, layer: DeepseekLayer, x: torch.Tensor,
                o: torch.Tensor) -> torch.Tensor:
        """The latent context o [T, nq, 576] through W_UV and wo, then the
        MLP (``deepseek.py:419-423, 123-139``)."""
        T = x.shape[0]
        o = bmm_f32(o[..., :self.kv_lora_rank].transpose(0, 1),
                    layer.w_uv).to(x.dtype).transpose(0, 1)
        x = x + o.reshape(T, -1) @ layer.wo
        h = rms_norm(x, layer.post_norm, self.rms_eps)
        return x + self._mlp(layer, h)

    def forward(self, input_ids: torch.Tensor, kv_cache: torch.Tensor,
                md: AttentionMetadata) -> torch.Tensor:
        """Prefill / mixed wave: [T] token ids -> [T, H] final hidden; the
        latent rows go into the paged cache [L, P, 2, 1, page, 576]."""
        x = self.embed[input_ids]
        cos, sin = compute_cos_sin(md.token_pos, self.inv_freq,
                                   self.rope_mscale)
        for li, layer in enumerate(self.layers):
            q, k, v = self._qkv(layer, x, cos, sin)
            write_kv(kv_cache, li, k, v, md.slot_mapping)
            o = paged_attention(q, kv_cache, li, md, self.scale)
            x = self._finish(layer, x, o)
        return rms_norm(x, self.final_norm, self.rms_eps)

    def forward_window(self, input_ids: torch.Tensor, kv_cache: torch.Tensor,
                       tail_k: torch.Tensor, tail_v: torch.Tensor,
                       md: AttentionMetadata) -> torch.Tensor:
        """One decode-window sub-step: the latent rows go into the tails [L,
        R, 1, Kw, 576]; the paged cache is only read."""
        x = self.embed[input_ids]
        cos, sin = compute_cos_sin(md.token_pos, self.inv_freq,
                                   self.rope_mscale)
        for li, layer in enumerate(self.layers):
            q, k, v = self._qkv(layer, x, cos, sin)
            write_tail(tail_k, k, li, md.window_step)
            write_tail(tail_v, v, li, md.window_step)
            o = window_attention(q, kv_cache, tail_k, tail_v, li, md,
                                 self.scale)
            x = self._finish(layer, x, o)
        return rms_norm(x, self.final_norm, self.rms_eps)

    def compute_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """[N, H] -> [N, V] float32 logits, accumulated in fp32."""
        head = self.embed.t() if self.tie_embeddings else self.lm_head
        return matmul_f32(hidden, head)


class DeepseekV3ForCausalLM(DeepseekV2ForCausalLM):
    """Sigmoid routing with the expert-score correction bias."""

    router_style = "v3"
