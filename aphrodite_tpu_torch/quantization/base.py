"""Quantization configuration of the PyTorch port.

The subset of the JAX package's ``quantization/base.py`` that on-the-fly
weight-only quantization reads: GPTQ/AWQ W4A16 (group 128, asymmetric
uint4) and W8A16 (per-channel int8). Every other method, a packed
checkpoint (an HF ``quantization_config``) and a quantized ``lm_head``
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

_PORTED = ("gptq", "awq", "w8a16")


@dataclasses.dataclass
class QuantizationConfig:
    method: str         # gptq | awq (asymmetric uint4) | w8a16 (int8)
    weight_bits: int = 8
    group_size: int = -1  # -1 = per-channel (K-wide group)

    @staticmethod
    def from_name(name: str) -> "QuantizationConfig":
        name = name.lower()
        if name == "w8a16":
            return QuantizationConfig(method="w8a16")
        if name in ("gptq", "awq"):
            return QuantizationConfig(method=name, weight_bits=4,
                                      group_size=128)
        raise NotImplementedError(
            f"quantization {name!r} is not ported; the PyTorch port "
            f"serves {list(_PORTED)}")


def runtime_format(qcfg: QuantizationConfig) -> str:
    """The format tag the model passes to ``apply_linear``."""
    return {"gptq": "w4a16", "awq": "w4a16", "w8a16": "w8a16"}[qcfg.method]


def get_quantization_config(model_config) -> Optional[QuantizationConfig]:
    """The explicit ``quantization=`` of the model config, or None."""
    if getattr(model_config.hf_config, "quantization_config", None):
        raise NotImplementedError(
            "packed (GPTQ/AWQ/...) checkpoints are not ported: only "
            "on-the-fly quantization of dummy weights is")
    if getattr(model_config, "quantize_lm_head", False):
        raise NotImplementedError("a quantized lm_head is not ported")
    if not model_config.quantization:
        return None
    return QuantizationConfig.from_name(model_config.quantization)
