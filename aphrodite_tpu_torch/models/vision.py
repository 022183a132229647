"""ViT vision encoders (CLIP / SigLIP style) of the multimodal models.

Counterpart of the JAX package's ``models/vision.py`` (``VisionTower``,
``:36-230``): patchify as one product (patches x the flattened conv
kernel), a class token and pre-LN (CLIP) or a patch bias (SigLIP), learned
positions, pre-LN transformer layers with bidirectional attention (no mask,
no KV cache), and an optional post-LN (SigLIP's last_hidden_state). The
layer weights are ``[Lv, ...]`` stacks, as in the JAX tree, with Q/K/V
fused on N (``w_qkv`` / ``b_qkv``: one product a layer).

The tower is no TPU kernel there (its products and attention are XLA
einsums, ``:200-214``), so here they are ``torch.matmul`` and
``scaled_dot_product_attention``, which never builds the [N, heads, P, P]
logits of a 4096-patch image. The JAX tower's "gelu" is ``jax.nn.gelu``,
whose default is the tanh approximation; so is this one's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aphrodite_tpu_torch.layers.common import layer_norm
from aphrodite_tpu_torch.layers.linear import matmul_f32
from aphrodite_tpu_torch.models.llama import _param


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# The JAX tower's activations (``vision.py:30-35``).
VISION_ACTS = {"quick_gelu": quick_gelu, "gelu": _gelu_tanh,
               "gelu_pytorch_tanh": _gelu_tanh, "gelu_new": _gelu_tanh}

# A layer's leaves: [Lv, ...] stacks (Q/K/V fused on N).
LAYER_LEAVES = ("ln1_w", "ln1_b", "w_qkv", "b_qkv", "wo", "bo", "ln2_w",
                "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


class VisionTower(nn.Module):
    """CLIP-style ViT (class token + pre-LN) with SigLIP's knobs
    (``cls_token=False``: a patch bias and no pre-LN; ``post_ln``).
    ``feature_layer``: HF's hidden_states index (-1: every layer, -2: stop
    one short)."""

    def __init__(self, vision_config, dtype: torch.dtype,
                 device: torch.device | str, *, cls_token: bool = True,
                 feature_layer: int = -2, post_ln: bool = False) -> None:
        super().__init__()
        vc = vision_config
        self.dtype = dtype
        self.hidden = D = vc.hidden_size
        self.num_layers = Lv = vc.num_hidden_layers
        self.heads = vc.num_attention_heads
        self.head_dim = D // self.heads
        self.intermediate = I = vc.intermediate_size
        self.patch = vc.patch_size
        self.image_size = vc.image_size
        self.grid = vc.image_size // vc.patch_size
        self.eps = getattr(vc, "layer_norm_eps", 1e-5)
        act = getattr(vc, "hidden_act", "quick_gelu")
        if act not in VISION_ACTS:
            raise NotImplementedError(f"vision activation {act!r} is not "
                                      "ported")
        self.act = VISION_ACTS[act]
        self.cls_token = cls_token
        self.post_ln = post_ln
        self.use_layers = Lv + 1 + feature_layer
        mk = dict(dtype=dtype, device=device)
        self.patch_w = _param(3 * self.patch * self.patch, D, **mk)
        self.pos = _param(self.grid * self.grid + int(cls_token), D, **mk)
        if cls_token:
            self.cls = _param(D, **mk)
            self.pre_ln_w = _param(D, **mk)
            self.pre_ln_b = _param(D, **mk)
        else:
            self.patch_b = _param(D, **mk)
        if post_ln:
            self.post_ln_w = _param(D, **mk)
            self.post_ln_b = _param(D, **mk)
        shapes = {"ln1_w": (D,), "ln1_b": (D,), "w_qkv": (D, 3 * D),
                  "b_qkv": (3 * D,), "wo": (D, D), "bo": (D,),
                  "ln2_w": (D,), "ln2_b": (D,), "fc1_w": (D, I),
                  "fc1_b": (I,), "fc2_w": (I, D), "fc2_b": (D,)}
        self.layers = nn.ParameterDict({
            k: _param(Lv, *shapes[k], **mk) for k in LAYER_LEAVES})

    @torch.no_grad()
    def init_dummy(self, generator: torch.Generator) -> None:
        """The JAX tower's dummy recipe (``vision.py:96-110``): ones for
        the norms' weights, zeros for biases, N(0, 0.02) drawn in fp32 for
        everything else."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("_b") or leaf.startswith("b") or "ln" in leaf:
                p.fill_(1.0 if leaf.endswith("w") else 0.0)
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=generator,
                                           device=p.device))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values [N, 3, S, S] -> features [N, P(+cls), D] at the
        configured feature layer (``vision.py:159-230``)."""
        N, ps, g, D = pixel_values.shape[0], self.patch, self.grid, self.hidden
        x = pixel_values.to(self.dtype)
        x = x.reshape(N, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(N * g * g, 3 * ps * ps)
        x = matmul_f32(x, self.patch_w).to(self.dtype).reshape(N, g * g, D)
        if self.cls_token:
            x = torch.cat([self.cls.expand(N, 1, D).to(x.dtype), x], dim=1)
        else:
            x = x + self.patch_b
        x = x + self.pos[None].to(x.dtype)
        if self.cls_token:
            x = layer_norm(x, self.pre_ln_w, self.pre_ln_b, self.eps)
        nh, hd = self.heads, self.head_dim
        P = x.shape[1]
        lp = self.layers
        for i in range(self.use_layers):
            h = layer_norm(x, lp["ln1_w"][i], lp["ln1_b"][i], self.eps)
            qkv = (h @ lp["w_qkv"][i] + lp["b_qkv"][i]).reshape(
                N, P, 3, nh, hd).permute(2, 0, 3, 1, 4)   # [3, N, nh, P, hd]
            o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2],
                                               scale=hd ** -0.5)
            o = o.transpose(1, 2).reshape(N, P, D)
            x = x + (o @ lp["wo"][i] + lp["bo"][i])
            h = layer_norm(x, lp["ln2_w"][i], lp["ln2_b"][i], self.eps)
            h = self.act(h @ lp["fc1_w"][i] + lp["fc1_b"][i])
            x = x + (h @ lp["fc2_w"][i] + lp["fc2_b"][i])
        if self.post_ln:
            x = layer_norm(x, self.post_ln_w, self.post_ln_b, self.eps)
        return x
