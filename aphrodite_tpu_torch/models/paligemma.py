"""PaliGemma 1 / 2: a SigLIP tower and a linear projector over Gemma or
Gemma-2.

Counterpart of the JAX package's ``models/paligemma.py``. The projected
image features are divided by sqrt(text hidden), as HF does; the Gemma
embedding scale multiplies them back after the scatter, so they enter the
residual stream unscaled (``paligemma.py:105-115``). Attention is causal
over the whole sequence (``paligemma.py:7-8``): no image spans.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from aphrodite_tpu_torch.config import ModelConfig
from aphrodite_tpu_torch.layers.linear import matmul_f32
from aphrodite_tpu_torch.models.gemma import (Gemma2ForCausalLM,
                                              GemmaForCausalLM)
from aphrodite_tpu_torch.models.llama import _param
from aphrodite_tpu_torch.models.vision import VisionTower
from aphrodite_tpu_torch.quantization.base import QuantizationConfig


class _PaliGemmaMixin:
    is_multimodal = True

    def _mm_init(self, config: ModelConfig, device) -> None:
        hf = config.hf_config
        self.vision = VisionTower(hf.vision_config, self.dtype, device,
                                  cls_token=False, feature_layer=-1,
                                  post_ln=True)
        self.image_token_id = hf.image_token_index
        self.proj_dim = getattr(hf, "projection_dim", self.hidden_size)
        mk = dict(dtype=self.dtype, device=device)
        self.projector = nn.ParameterDict({
            "w": _param(self.vision.hidden, self.proj_dim, **mk),
            "b": _param(self.proj_dim, **mk)})

    @torch.no_grad()
    def init_dummy_params(self, generator: torch.Generator) -> None:
        """The decoder's dummy weights, the tower's recipe, and the JAX
        projector's: N(0, 0.02) ``w``, zeros for ``b``."""
        super().init_dummy_params(generator)
        self.vision.init_dummy(generator)
        self.projector["b"].zero_()

    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[N, 3, S, S] -> [N * patches, projection dim]."""
        feats = self.vision(pixel_values)
        N, P, D = feats.shape
        h = matmul_f32(feats.reshape(N * P, D), self.projector["w"]).to(
            feats.dtype) + self.projector["b"]
        return h / torch.tensor(self.hidden_size ** 0.5,
                                dtype=feats.dtype, device=h.device)


_CLASSES: dict[type, type] = {}


def PaliGemmaForConditionalGeneration(
        config: ModelConfig, device: torch.device | str = "cpu",
        quant_config: Optional[QuantizationConfig] = None) -> nn.Module:
    """PaliGemma on the text config's base: Gemma-2 where its model_type
    says so (PaliGemma 2), else Gemma (``paligemma.py:125-135``)."""
    base = (Gemma2ForCausalLM
            if config.get("model_type", "gemma") == "gemma2"
            else GemmaForCausalLM)
    cls = _CLASSES.get(base)
    if cls is None:
        cls = _CLASSES[base] = type("PaliGemma" + base.__name__,
                                    (_PaliGemmaMixin, base), {})
    model = cls(config, device, quant_config)
    model._mm_init(config, device)
    return model
