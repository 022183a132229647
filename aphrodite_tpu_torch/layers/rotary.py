"""Rotary position embeddings (HF rotate-half convention).

The default frequencies, linear scaling and Llama 3's frequency scaling are
ported; every other rope scaling mode raises ``NotImplementedError``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class RopeConfig:
    head_dim: int
    rotary_dim: int
    base: float = 10000.0
    scaling: Optional[dict] = None  # HF rope_scaling dict

    @staticmethod
    def from_hf_config(hf_config, head_dim: int) -> "RopeConfig":
        partial = getattr(hf_config, "partial_rotary_factor", 1.0)
        scaling = getattr(hf_config, "rope_scaling", None)
        if scaling is not None and not isinstance(scaling, dict):
            scaling = dict(scaling)
        return RopeConfig(
            head_dim=head_dim,
            rotary_dim=int(head_dim * partial),
            base=getattr(hf_config, "rope_theta", 10000.0),
            scaling=scaling,
        )


def compute_inv_freq(cfg: RopeConfig) -> np.ndarray:
    """inv_freq [rotary_dim//2] float32: default frequencies, linear
    scaling (positions / factor) or Llama 3's frequency scaling (the JAX
    package's ``rotary.py:74-91``), equal to it bit for bit."""
    s = cfg.scaling or {}
    rope_type = s.get("rope_type", s.get("type", "default"))
    if rope_type not in ("default", "linear", "llama3"):
        raise NotImplementedError(
            f"rope scaling {rope_type!r} is not ported yet")
    dim = cfg.rotary_dim
    inv_freq = 1.0 / (cfg.base ** (np.arange(0, dim, 2, dtype=np.float64)
                                   / dim))
    if rope_type == "linear":
        inv_freq = inv_freq * (1.0 / s.get("factor", 1.0))
    elif rope_type == "llama3":
        factor = s.get("factor", 8.0)
        low_f = s.get("low_freq_factor", 1.0)
        high_f = s.get("high_freq_factor", 4.0)
        orig_max = s.get("original_max_position_embeddings", 8192)
        wavelen = 2 * math.pi / inv_freq
        low_wl = orig_max / low_f
        high_wl = orig_max / high_f
        smooth = np.clip((orig_max / wavelen - low_f) / (high_f - low_f),
                         0, 1)
        interp = (1 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = np.where(wavelen > low_wl, inv_freq / factor,
                            np.where(wavelen < high_wl, inv_freq, interp))
    return inv_freq.astype(np.float32)


def compute_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [T] int -> (cos, sin) each [T, rotary_dim//2] float32."""
    freqs = positions.float()[:, None] * inv_freq[None, :]
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [T, heads, head_dim]; cos/sin: [T, rotary_dim//2]. Rotate-half on
    the leading ``rotary_dim`` dims in fp32; the tail passes through."""
    rot = cos.shape[-1] * 2
    half = rot // 2
    xf = x[..., :rot].float()
    x1, x2 = xf[..., :half], xf[..., half:]
    c, s = cos[:, None, :], sin[:, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
    if x.shape[-1] > rot:
        out = torch.cat([out, x[..., rot:]], dim=-1)
    return out
