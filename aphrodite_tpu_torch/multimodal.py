"""Multimodal inputs: images -> pixel arrays + placeholder spans.

Counterpart of the JAX package's ``multimodal.py`` for the ported vision
models: ``MMInputs`` (``:23-45``), the payload a request carries, and the
adapters of LLaVA (``:88-194``), PaliGemma (``:197``) and Gemma-3
(``:535``), which preprocess images into normalised CHW arrays and expand
each image placeholder of a token-id prompt into the image's run of
placeholder tokens, recording each image's span. Adapters read the HF
config only, never the model.

Images are HWC arrays (uint8, or float in [0, 1]), CHW float arrays that
are already normalised (passed through), or PIL images, which alone are
resized and need PIL (imported only when one is given).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np


@dataclass
class MMInputs:
    """A request's processed multimodal payload."""
    # Model-ready pixels [N_images, 3, S, S] float32.
    pixel_values: np.ndarray
    # Per image: (token offset, token count) of its span in the expanded
    # prompt.
    spans: list[tuple[int, int]]
    _hash: Optional[int] = field(default=None, repr=False, compare=False)

    def content_hash(self) -> int:
        """Mixed into the KV page hashes (``core/kv_cache_manager.py``), so
        that equal placeholder ids with different images never share
        cached pages; also the encoder cache's key. The JAX package's
        value (the hash of the pixels' bytes), taken once: an 896 x 896
        image is 9.6 MB of float32."""
        if self._hash is None:
            self._hash = hash(self.pixel_values.tobytes())
        return self._hash


class LlavaAdapter:
    """LLaVA-style VLMs: one flat grid of ViT patch tokens an image, merged
    at ``image_token_index`` positions."""

    media_key = "image"

    def __init__(self, hf_config) -> None:
        vc = hf_config.vision_config
        self.image_token_id = hf_config.image_token_index
        self.image_size = vc.image_size
        self.patch_size = vc.patch_size
        grid = vc.image_size // vc.patch_size
        strategy = getattr(hf_config, "vision_feature_select_strategy",
                           "default")
        self.tokens_per_image = grid * grid + (1 if strategy == "full"
                                               else 0)
        self.image_mean = np.asarray(
            getattr(vc, "image_mean", (0.48145466, 0.4578275, 0.40821073)),
            np.float32)
        self.image_std = np.asarray(
            getattr(vc, "image_std", (0.26862954, 0.26130258, 0.27577711)),
            np.float32)

    def preprocess(self, images: Any) -> np.ndarray:
        """images: one of, or a list of: a PIL image, an HWC uint8 or float
        array, or a normalised CHW float array; or an NCHW batch."""
        if isinstance(images, np.ndarray) and images.ndim == 4:
            images = list(images)
        elif not isinstance(images, (list, tuple)):
            images = [images]
        return np.stack([self._to_chw(img) for img in images]).astype(
            np.float32)

    def _to_chw(self, img) -> np.ndarray:
        S = self.image_size
        if hasattr(img, "resize") and not isinstance(img, np.ndarray):
            # A PIL image: bicubic resize to the model's square size.
            img = np.asarray(img.convert("RGB").resize((S, S), resample=3))
        arr = np.asarray(img)
        if arr.ndim != 3:
            raise ValueError(f"image must be HWC or CHW, got {arr.shape}")
        if arr.shape[0] == 3 and arr.shape[-1] != 3:
            # CHW float: already normalised; checked for size only.
            if arr.shape[1] != S or arr.shape[2] != S:
                raise ValueError(
                    f"CHW pixel input must be [3,{S},{S}], got {arr.shape}")
            return arr.astype(np.float32)
        if arr.shape[1] != S or arr.shape[0] != S:
            raise ValueError(
                f"HWC image must be {S}x{S} (resize first or pass PIL), "
                f"got {arr.shape}")
        arr = arr.astype(np.float32)
        if arr.max() > 1.5:  # uint8 range
            arr = arr / 255.0
        arr = (arr - self.image_mean) / self.image_std
        return arr.transpose(2, 0, 1)

    def expand_prompt(self, token_ids: list[int], num_images: int
                      ) -> tuple[list[int], list[tuple[int, int]]]:
        """Expand image placeholders to ``tokens_per_image`` repeats: one
        placeholder an image, or a prompt already expanded (num_images *
        tokens_per_image placeholders, e.g. from an HF processor), whose
        spans are the runs of placeholders. Returns the expanded ids and
        each image's (offset, length)."""
        tid, P = self.image_token_id, self.tokens_per_image
        occurrences = [i for i, t in enumerate(token_ids) if t == tid]
        spans: list[tuple[int, int]] = []
        if len(occurrences) == num_images * P and num_images > 0:
            run_start, prev = None, -2
            for i in occurrences + [-1]:
                if i != prev + 1:
                    if run_start is not None:
                        spans.append((run_start, prev - run_start + 1))
                    run_start = i
                prev = i
            if sum(n for _, n in spans) != num_images * P:
                raise ValueError("placeholder runs do not tile images")
            return list(token_ids), spans
        if len(occurrences) != num_images:
            raise ValueError(
                f"prompt has {len(occurrences)} image placeholders for "
                f"{num_images} images")
        expanded: list[int] = []
        for t in token_ids:
            if t == tid:
                spans.append((len(expanded), P))
                expanded.extend([tid] * P)
            else:
                expanded.append(t)
        return expanded, spans


class PaliGemmaAdapter(LlavaAdapter):
    """PaliGemma: the SigLIP grid (no class token), 0.5 / 0.5
    normalisation."""

    def __init__(self, hf_config) -> None:
        super().__init__(hf_config)
        vc = hf_config.vision_config
        grid = vc.image_size // vc.patch_size
        self.tokens_per_image = grid * grid
        self.image_mean = np.asarray(
            getattr(vc, "image_mean", (0.5, 0.5, 0.5)), np.float32)
        self.image_std = np.asarray(
            getattr(vc, "image_std", (0.5, 0.5, 0.5)), np.float32)


class Gemma3Adapter(LlavaAdapter):
    """Gemma-3 MM: the SigLIP grid pooled to ``mm_tokens_per_image``
    placeholder tokens, 0.5 / 0.5 normalisation, pan-and-scan off (the
    serving default). The prompt holds boi, the placeholder and eoi; only
    the placeholder is expanded."""

    def __init__(self, hf_config) -> None:
        super().__init__(hf_config)
        vc = hf_config.vision_config
        self.tokens_per_image = int(getattr(hf_config,
                                            "mm_tokens_per_image", 256))
        self.image_mean = np.asarray(
            getattr(vc, "image_mean", (0.5, 0.5, 0.5)), np.float32)
        self.image_std = np.asarray(
            getattr(vc, "image_std", (0.5, 0.5, 0.5)), np.float32)


_ADAPTERS = {
    "LlavaForConditionalGeneration": LlavaAdapter,
    "PaliGemmaForConditionalGeneration": PaliGemmaAdapter,
    "Gemma3ForConditionalGeneration": Gemma3Adapter,
}


def get_mm_adapter(hf_config) -> Optional[LlavaAdapter]:
    """The adapter of the config's architecture, or None for a text
    model."""
    for a in getattr(hf_config, "architectures", None) or []:
        cls = _ADAPTERS.get(a)
        if cls is not None:
            return cls(hf_config)
    return None
