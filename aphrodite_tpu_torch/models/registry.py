"""Architecture registry of the port: HF ``architectures[0]`` -> model
class (the ported subset of the JAX package's ``models/registry.py``),
imported at first use."""
from __future__ import annotations

import importlib
from typing import Optional

# arch name -> (module under aphrodite_tpu_torch.models, class name)
MODEL_REGISTRY: dict[str, tuple[str, str]] = {
    "LlamaForCausalLM": ("llama", "LlamaForCausalLM"),
    "Qwen2ForCausalLM": ("llama", "Qwen2ForCausalLM"),
    "GemmaForCausalLM": ("gemma", "GemmaForCausalLM"),
    "Gemma2ForCausalLM": ("gemma", "Gemma2ForCausalLM"),
    "Gemma3ForCausalLM": ("gemma", "Gemma3ForCausalLM"),
    "Gemma3ForConditionalGeneration": ("gemma3_mm",
                                       "Gemma3ForConditionalGeneration"),
    "PaliGemmaForConditionalGeneration": (
        "paligemma", "PaliGemmaForConditionalGeneration"),
    "MixtralForCausalLM": ("mixtral", "MixtralForCausalLM"),
    "QuantMixtralForCausalLM": ("mixtral", "MixtralForCausalLM"),
    "Qwen2MoeForCausalLM": ("mixtral", "Qwen2MoeForCausalLM"),
    "Qwen3MoeForCausalLM": ("mixtral", "Qwen3MoeForCausalLM"),
    "OlmoeForCausalLM": ("mixtral", "OlmoeForCausalLM"),
    "DeepseekForCausalLM": ("mixtral", "DeepseekForCausalLM"),
    "DeepseekV2ForCausalLM": ("deepseek", "DeepseekV2ForCausalLM"),
    "DeepseekV3ForCausalLM": ("deepseek", "DeepseekV3ForCausalLM"),
    "MambaForCausalLM": ("mamba", "MambaForCausalLM"),
    "FalconMambaForCausalLM": ("mamba", "FalconMambaForCausalLM"),
    "Mamba2ForCausalLM": ("mamba", "Mamba2ForCausalLM"),
    "BloomForCausalLM": ("llama_variants", "BloomForCausalLM"),
    "MPTForCausalLM": ("llama_variants", "MPTForCausalLM"),
    "MptForCausalLM": ("llama_variants", "MPTForCausalLM"),
    "FalconForCausalLM": ("llama_variants", "FalconForCausalLM"),
    "RWForCausalLM": ("llama_variants", "FalconForCausalLM"),
    "BaichuanForCausalLM": ("llama_variants", "BaichuanForCausalLM"),
    "BaiChuanForCausalLM": ("llama_variants", "BaiChuanForCausalLM"),
}


def model_class(architecture: Optional[str]) -> type:
    entry = MODEL_REGISTRY.get(architecture or "")
    if entry is None:
        raise NotImplementedError(
            f"architecture {architecture!r} is not ported; the PyTorch "
            f"port serves {sorted(MODEL_REGISTRY)}")
    module, name = entry
    return getattr(importlib.import_module(
        f"aphrodite_tpu_torch.models.{module}"), name)
