"""Quantization configuration of the PyTorch port.

The subset of the JAX package's ``quantization/base.py`` that on-the-fly
quantization reads (``from_name``, ``runtime_format``: ``:174-186,
258-263``): GPTQ/AWQ W4A16 (group 128, asymmetric uint4), W8A16
(per-channel int8), FP8 (e4m3 weights with a per-channel scale; "fp8"
weight-only, "fp8_w8a8" / "fp8-dynamic" / "ptpc_fp8" with dynamic
per-token e4m3 activations too) and int8 W8A8 ("int8" / "tpu_int8"). FPx
and deepspeedfp, a packed checkpoint (an HF ``quantization_config``) and a
quantized ``lm_head`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

_PORTED = ("gptq", "awq", "w8a16", "fp8", "fp8_w8a8", "fp8-dynamic",
           "ptpc_fp8", "int8", "tpu_int8")


@dataclasses.dataclass
class QuantizationConfig:
    # gptq | awq (asymmetric uint4) | w8a16 (int8 weights) | int8 (W8A8) |
    # fp8 (e4m3 weights)
    method: str
    weight_bits: int = 8
    group_size: int = -1  # -1 = per-channel (K-wide group)
    # fp8: "dynamic" quantizes the activations per token too (W8A8).
    activation_scheme: Optional[str] = None

    @staticmethod
    def from_name(name: str) -> "QuantizationConfig":
        name = name.lower()
        if name in ("tpu_int8", "int8"):
            return QuantizationConfig(method="int8")
        if name == "w8a16":
            return QuantizationConfig(method="w8a16")
        if name == "fp8":
            return QuantizationConfig(method="fp8")
        if name in ("fp8_w8a8", "fp8-dynamic", "ptpc_fp8"):
            return QuantizationConfig(method="fp8",
                                      activation_scheme="dynamic")
        if name in ("gptq", "awq"):
            return QuantizationConfig(method=name, weight_bits=4,
                                      group_size=128)
        raise NotImplementedError(
            f"quantization {name!r} is not ported; the PyTorch port "
            f"serves {list(_PORTED)}")


def runtime_format(qcfg: QuantizationConfig) -> str:
    """The format tag the model passes to ``apply_linear``."""
    if qcfg.method == "fp8" and qcfg.activation_scheme:
        return "fp8_w8a8"
    return {"gptq": "w4a16", "awq": "w4a16", "w8a16": "w8a16",
            "int8": "int8", "fp8": "fp8"}[qcfg.method]


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
