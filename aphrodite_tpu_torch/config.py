"""Engine configuration tree of the PyTorch port.

The subset of the JAX package's ``aphrodite_tpu/config.py`` that the
serving main path reads. ``ModelConfig`` takes the HF-style geometry as a
plain ``dict`` or as any object with the same attributes (a
``transformers`` config works too), so nothing here needs the
``transformers`` package. A multimodal config nests its language model's
geometry under ``text_config`` and its vision tower's under
``vision_config`` (as dicts or objects); the geometry properties and
``get`` read the text config (``aphrodite_tpu/config.py:193-200``).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Optional

from aphrodite_tpu_torch.utils import cdiv, torch_dtype

# Valid KV-cache dtypes (``aphrodite_tpu/config.py:26``).
KV_CACHE_DTYPES = ("auto", "fp8", "fp8_e4m3", "fp8_e5m2")

# Remote-code spellings of the geometry, filled into a dict config where
# the canonical name is missing (``aphrodite_tpu/config.py:116-124``, its
# generic-config path; a ``transformers`` config maps them itself).
_ALIASES = {
    "num_attention_heads": ("n_head", "n_heads"),
    "num_hidden_layers": ("n_layer", "n_layers", "num_layers"),
    "hidden_size": ("d_model", "n_embd"),
    "intermediate_size": ("n_inner",),
    "max_position_embeddings": ("max_seq_len", "model_max_length",
                                "seq_length", "n_positions"),
}


# Nested sub-configs of a multimodal dict config, made namespaces as the
# top level is (``aphrodite_tpu/config.py:132-145``).
_SUBCONFIGS = ("text_config", "vision_config")


def _namespace(d: dict) -> SimpleNamespace:
    """A dict config as a namespace, with the remote-code spellings of the
    geometry filled in where the canonical name is missing."""
    d = dict(d)
    for canon, alts in _ALIASES.items():
        given = [d[a] for a in alts if a in d]
        if canon not in d and given:
            d[canon] = given[0]
    return SimpleNamespace(**d)


@dataclass
class ModelConfig:
    """The model to serve: architecture and geometry."""

    model: str
    tokenizer: Optional[str] = None
    dtype: str = "bfloat16"
    seed: int = 0
    max_model_len: Optional[int] = None
    # Quantization applied on the fly: "gptq" | "awq" (W4A16, group 128) |
    # "w8a16" | "fp8" (e4m3 weights) | "fp8_w8a8" (also e4m3 activations,
    # dynamic per token) | "int8" (W8A8); None = full precision
    # (``quantization/base.py``).
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
            d = {k: _namespace(v) if k in _SUBCONFIGS and isinstance(v, dict)
                 else v for k, v in self.hf_config.items()}
            self.hf_config = _namespace(d)
        archs = getattr(self.hf_config, "architectures", None) or []
        self.architecture: Optional[str] = archs[0] if archs else None
        derived_max = self.get("max_position_embeddings") or 2048
        if self.max_model_len is None:
            self.max_model_len = derived_max

    @property
    def text_config(self):
        """The language model's config: ``text_config`` of a multimodal
        config, else the config itself."""
        return getattr(self.hf_config, "text_config", None) or self.hf_config

    def get(self, name: str, default=None):
        """A field of the text config (``text_config``)."""
        return getattr(self.text_config, name, default)

    @property
    def hidden_size(self) -> int:
        return self.text_config.hidden_size

    @property
    def num_layers(self) -> int:
        return self.text_config.num_hidden_layers

    @property
    def is_attention_free(self) -> bool:
        """Recurrent-state models (Mamba family): no KV cache at all."""
        return self.get("num_attention_heads") in (None, 0) or self.get(
            "model_type") in ("mamba", "mamba2", "falcon_mamba")

    @property
    def num_attention_heads(self) -> int:
        return self.get("num_attention_heads") or 1

    @property
    def uses_mla(self) -> bool:
        """DeepSeek-style multi-head latent attention
        (``aphrodite_tpu/config.py:228-234``): the cache holds one latent
        row a token, kv_lora_rank + qk_rope_head_dim wide, as one KV head."""
        return self.get("kv_lora_rank") is not None

    @property
    def num_kv_heads(self) -> int:
        """KV heads (``aphrodite_tpu/config.py:236-251``): one under MLA;
        Falcon's ``num_kv_heads`` in its new architecture, else one under
        ``multi_query``; else ``num_key_value_heads``. MPT's
        ``attn_config.kv_n_heads`` is not read: the reference reads that
        field for DBRX only, so an MPT that sets it keeps one KV head a
        query head, as there."""
        if self.is_attention_free or self.uses_mla:
            return 1
        model_type = self.get("model_type", "")
        if model_type == "falcon":
            if self.get("new_decoder_architecture", False):
                return self.get("num_kv_heads") or self.num_attention_heads
            return 1 if self.get("multi_query", False) \
                else self.num_attention_heads
        return self.get("num_key_value_heads") or self.num_attention_heads

    @property
    def head_dim(self) -> int:
        if self.uses_mla:  # the latent head (``config.py:279-281``)
            return self.get("kv_lora_rank") + self.get("qk_rope_head_dim")
        if self.is_attention_free:
            return self.get("state_size", 16)
        return self.get("head_dim") or (self.hidden_size
                                        // self.num_attention_heads)

    @property
    def vocab_size(self) -> int:
        return self.text_config.vocab_size

    @property
    def intermediate_size(self) -> int:
        return self.text_config.intermediate_size

    @property
    def sliding_window(self) -> Optional[int]:
        if not self.get("use_sliding_window", True):
            return None
        return self.get("sliding_window")


@dataclass
class CacheConfig:
    """Paged KV cache geometry and dtype."""

    block_size: int = 32
    # KV pages in the pool; None = the worker sizes it from free memory.
    num_blocks: Optional[int] = None
    # Content-hash reuse of full pages; the worker turns it off for
    # recurrent-state models, whose pages hold nothing to reuse.
    enable_prefix_caching: bool = True
    # "auto" (the model's dtype) or an fp8 cache: "fp8" / "fp8_e4m3"
    # (e4m3fn) or "fp8_e5m2".
    cache_dtype: str = "auto"

    def __post_init__(self) -> None:
        if self.cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"cache_dtype must be one of {KV_CACHE_DTYPES}")
        if self.block_size & (self.block_size - 1):
            raise ValueError("block_size must be a power of two")

    def torch_dtype(self, model_dtype):
        """The cache's torch dtype (``aphrodite_tpu/worker/runner.py:92-96``):
        the model's for "auto", else e5m2 for "fp8_e5m2" and e4m3fn for
        "fp8" and "fp8_e4m3"."""
        if self.cache_dtype == "auto":
            return torch_dtype(model_dtype)
        return torch_dtype("float8_e5m2" if self.cache_dtype == "fp8_e5m2"
                           else "float8_e4m3")


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
