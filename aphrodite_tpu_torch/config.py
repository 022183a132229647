"""Engine configuration tree of the PyTorch port.

The subset of the JAX package's ``aphrodite_tpu/config.py`` that the
serving main path reads. ``ModelConfig`` takes the HF-style geometry as a
plain ``dict`` or as any object with the same attributes (a
``transformers`` config works too), so nothing here needs the
``transformers`` package.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Optional

from aphrodite_tpu_torch.utils import cdiv


@dataclass
class ModelConfig:
    """The model to serve: architecture and geometry."""

    model: str
    tokenizer: Optional[str] = None
    dtype: str = "bfloat16"
    seed: int = 0
    max_model_len: Optional[int] = None
    # Weight-only quantization applied on the fly: "gptq" | "awq" (W4A16,
    # group 128) | "w8a16"; None = full precision.
    quantization: Optional[str] = None
    # A quantized lm_head is not ported: True raises at engine start.
    quantize_lm_head: bool = False
    # HF-style geometry: a dict, or any object with those attributes. When
    # None, ``<model>/config.json`` is read as plain JSON.
    hf_config: Any = None

    def __post_init__(self) -> None:
        if self.tokenizer is None:
            self.tokenizer = self.model
        if self.hf_config is None:
            with open(os.path.join(str(self.model), "config.json")) as f:
                self.hf_config = json.load(f)
        if isinstance(self.hf_config, dict):
            self.hf_config = SimpleNamespace(**self.hf_config)
        archs = getattr(self.hf_config, "architectures", None) or []
        self.architecture: Optional[str] = archs[0] if archs else None
        derived_max = getattr(self.hf_config, "max_position_embeddings",
                              None) or 2048
        if self.max_model_len is None:
            self.max_model_len = derived_max

    def get(self, name: str, default=None):
        return getattr(self.hf_config, name, default)

    @property
    def hidden_size(self) -> int:
        return self.hf_config.hidden_size

    @property
    def num_layers(self) -> int:
        return self.hf_config.num_hidden_layers

    @property
    def is_attention_free(self) -> bool:
        """Recurrent-state models (Mamba family): no KV cache at all."""
        return self.get("num_attention_heads") in (None, 0) or self.get(
            "model_type") in ("mamba", "mamba2", "falcon_mamba")

    @property
    def num_attention_heads(self) -> int:
        return self.get("num_attention_heads") or 1

    @property
    def num_kv_heads(self) -> int:
        if self.is_attention_free:
            return 1
        return self.get("num_key_value_heads") or self.num_attention_heads

    @property
    def head_dim(self) -> int:
        if self.is_attention_free:
            return self.get("state_size", 16)
        return self.get("head_dim") or (self.hidden_size
                                        // self.num_attention_heads)

    @property
    def vocab_size(self) -> int:
        return self.hf_config.vocab_size

    @property
    def intermediate_size(self) -> int:
        return self.hf_config.intermediate_size

    @property
    def sliding_window(self) -> Optional[int]:
        if not self.get("use_sliding_window", True):
            return None
        return self.get("sliding_window")


@dataclass
class CacheConfig:
    """Paged KV cache geometry."""

    block_size: int = 32
    # KV pages in the pool; None = the worker sizes it from free memory.
    num_blocks: Optional[int] = None
    # Content-hash reuse of full pages; the worker turns it off for
    # recurrent-state models, whose pages hold nothing to reuse.
    enable_prefix_caching: bool = True

    def __post_init__(self) -> None:
        if self.block_size & (self.block_size - 1):
            raise ValueError("block_size must be a power of two")


@dataclass
class SchedulerConfig:
    """Token-budget continuous-batching scheduler knobs."""

    max_num_seqs: int = 128
    max_num_batched_tokens: int = 2048
    max_model_len: int = 2048

    def __post_init__(self) -> None:
        if self.max_num_batched_tokens < 1:
            raise ValueError("max_num_batched_tokens must be >= 1")


@dataclass
class DeviceConfig:
    device: str = "auto"  # auto | cuda | cpu

    def resolve(self) -> str:
        """'cpu' only when asked for; everything else needs a CUDA card and
        never falls back to the CPU."""
        if self.device == "cpu":
            return "cpu"
        if self.device not in ("auto", "cuda"):
            raise ValueError(f"unknown device {self.device!r}")
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={self.device!r} needs a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        return "cuda"


@dataclass
class LoadConfig:
    load_format: str = "dummy"  # only dummy weights are ported


@dataclass
class EngineConfig:
    model_config: ModelConfig
    cache_config: CacheConfig = field(default_factory=CacheConfig)
    scheduler_config: SchedulerConfig = field(default_factory=SchedulerConfig)
    device_config: DeviceConfig = field(default_factory=DeviceConfig)
    load_config: LoadConfig = field(default_factory=LoadConfig)
    # Decode steps run per window with a frozen paged cache (the JAX
    # package's TPUConfig.multi_step_decode). 1 = single-step decode.
    decode_window: int = 64

    def __post_init__(self) -> None:
        mc, sc = self.model_config, self.scheduler_config
        sc.max_model_len = min(sc.max_model_len, mc.max_model_len) \
            if sc.max_model_len else mc.max_model_len
        if sc.max_num_batched_tokens < self.cache_config.block_size:
            raise ValueError(
                "max_num_batched_tokens must be >= cache block_size")

    @property
    def max_lookahead_tokens(self) -> int:
        """KV slots allocated past the sampled token (the decode window)."""
        return max(0, self.decode_window - 1)

    @property
    def max_blocks_per_req(self) -> int:
        return cdiv(self.scheduler_config.max_model_len
                    + self.max_lookahead_tokens,
                    self.cache_config.block_size)
