"""Gemma-3 multimodal: a SigLIP tower and an average-pool projector over
the Gemma-3 text decoder.

Counterpart of the JAX package's ``models/gemma3_mm.py``. The projector
average-pools the tower's p x p patch grid to ``mm_tokens_per_image``
tokens, RMS-normalises them with Gemma's offset of 1, projects them to the
text width and divides them by the embedding scale, which the decoder
multiplies back after it scatters them over the image placeholders
(``gemma3_mm.py:102-121``). The image tokens of one image attend to each
other in either order: the runner fills ``md.mm_bidir_spans`` for a model
that sets ``needs_bidir_mm`` (``worker/runner.py:1054-1066``), and the
ragged kernel takes the spans (its span option, a template switch of the
tensor-core instance). Each image's span must be prefilled in one chunk,
as the JAX model assumes (``gemma3_mm.py:10-12``): size the batch budget
for it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from aphrodite_tpu_torch.config import ModelConfig
from aphrodite_tpu_torch.layers.common import rms_norm
from aphrodite_tpu_torch.layers.linear import matmul_f32
from aphrodite_tpu_torch.models.gemma import Gemma3ForCausalLM
from aphrodite_tpu_torch.models.llama import _param
from aphrodite_tpu_torch.models.vision import VisionTower
from aphrodite_tpu_torch.quantization.base import QuantizationConfig


class Gemma3ForConditionalGeneration(Gemma3ForCausalLM):
    is_multimodal = True
    needs_bidir_mm = True

    def __init__(self, config: ModelConfig,
                 device: torch.device | str = "cpu",
                 quant_config: Optional[QuantizationConfig] = None) -> None:
        super().__init__(config, device, quant_config)
        hf = config.hf_config
        vc = hf.vision_config
        self.vision = VisionTower(vc, self.dtype, device, cls_token=False,
                                  feature_layer=-1, post_ln=True)
        self.image_token_id = hf.image_token_index
        self.patches_per_image = vc.image_size // vc.patch_size
        self.tokens_per_side = int(
            getattr(hf, "mm_tokens_per_image", 256) ** 0.5)
        self.vision_eps = getattr(vc, "layer_norm_eps", 1e-6)
        mk = dict(dtype=self.dtype, device=device)
        self.projector = nn.ParameterDict({
            "proj": _param(self.vision.hidden, self.hidden_size, **mk),
            "soft_emb_norm": _param(self.vision.hidden, **mk)})

    @torch.no_grad()
    def init_dummy_params(self, generator: torch.Generator) -> None:
        """The text decoder's dummy weights, the tower's recipe, and the
        JAX projector's: N(0, 0.02) ``proj``, ones for ``soft_emb_norm``."""
        super().init_dummy_params(generator)
        self.vision.init_dummy(generator)

    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[N, 3, S, S] -> [N * tokens_per_image, text hidden]."""
        feats = self.vision(pixel_values)
        N, _, D = feats.shape
        p, ts = self.patches_per_image, self.tokens_per_side
        k = p // ts
        x = feats.reshape(N, p // k, k, p // k, k, D).mean(dim=(2, 4))
        x = rms_norm(x.reshape(N * ts * ts, D),
                     self.projector["soft_emb_norm"], self.vision_eps,
                     offset=1.0)
        h = matmul_f32(x, self.projector["proj"]).to(feats.dtype)
        # The decoder multiplies every row by embed_scale after the
        # scatter; HF leaves image features unscaled: pre-divide.
        return h / torch.tensor(self.embed_scale, dtype=torch.float32).to(
            h.dtype)
