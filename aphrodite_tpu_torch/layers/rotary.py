"""Rotary position embeddings: HF's rotate-half convention
(``apply_rope``) and the pair-interleaved one of GPT-J and DeepSeek
(``apply_rope_interleaved``).

The default frequencies, linear scaling, Llama 3's frequency scaling, YaRN
and DeepSeek's YaRN are ported (the JAX package's ``layers/rotary.py``, bit
for bit); ``dynamic`` and ``longrope`` raise ``NotImplementedError``.
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
    # YaRN's original_max_position_embeddings when the dict has none.
    max_position: int = 2048

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
            max_position=getattr(hf_config, "max_position_embeddings", 2048),
        )


def _yarn_find_dim(num_rot: float, dim: int, base: float,
                   max_pos: int) -> float:
    return (dim * math.log(max_pos / (num_rot * 2 * math.pi))) / \
        (2 * math.log(base))


def _yarn_ramp(low: float, high: float, dim: int) -> np.ndarray:
    if low == high:
        high += 0.001
    ramp = (np.arange(dim, dtype=np.float32) - low) / (high - low)
    return np.clip(ramp, 0, 1)


def deepseek_yarn_mscale(scale: float, mscale: float) -> float:
    """DeepSeek's yarn_get_mscale (the JAX package's ``rotary.py:162-166``):
    0.1 * mscale * ln(scale) + 1 above a scale of 1, else 1."""
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def compute_inv_freq(cfg: RopeConfig, with_mscale: bool = False):
    """inv_freq [rotary_dim//2] float32 (and with ``with_mscale`` the
    magnitude that cos and sin take, a float): default frequencies, linear
    scaling (positions / factor), Llama 3's frequency scaling, YaRN and
    DeepSeek's YaRN (the JAX package's ``rotary.py:61-160``), equal to it
    bit for bit. Without ``with_mscale`` a mode whose magnitude is not 1
    raises, so that no caller drops it."""
    s = cfg.scaling or {}
    rope_type = s.get("rope_type", s.get("type", "default"))
    if rope_type not in ("default", "linear", "llama3", "yarn",
                         "deepseek_yarn"):
        raise NotImplementedError(
            f"rope scaling {rope_type!r} is not ported yet")
    dim = cfg.rotary_dim
    mscale = 1.0
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
    elif rope_type in ("yarn", "deepseek_yarn"):
        # The same frequency interpolation; YaRN's magnitude is its own
        # mscale, DeepSeek's the ratio of the mscales of the checkpoint's
        # `mscale` and `mscale_all_dim` (the model folds the rest,
        # mscale_all_dim squared, into its softmax scale).
        factor = s.get("factor", 1.0)
        orig_max = s.get("original_max_position_embeddings", cfg.max_position)
        low = math.floor(_yarn_find_dim(s.get("beta_fast", 32), dim,
                                        cfg.base, orig_max))
        high = math.ceil(_yarn_find_dim(s.get("beta_slow", 1), dim,
                                        cfg.base, orig_max))
        low, high = max(low, 0), min(high, dim - 1)
        mask = 1 - _yarn_ramp(low / 2, high / 2, dim // 2)
        inv_freq = inv_freq / factor * mask + inv_freq * (1 - mask)
        attn_factor = s.get("attn_factor", 1.0)
        if rope_type == "yarn":
            if factor > 1.0:
                mscale = (0.1 * math.log(factor) + 1.0) * attn_factor
        else:
            mscale = float(
                deepseek_yarn_mscale(factor, float(s.get("mscale", 1.0))) /
                deepseek_yarn_mscale(factor,
                                     float(s.get("mscale_all_dim", 0.0)))
                * attn_factor)
    inv_freq = inv_freq.astype(np.float32)
    if with_mscale:
        return inv_freq, float(mscale)
    if mscale != 1.0:
        raise NotImplementedError(
            f"rope scaling {rope_type!r} with a magnitude of {mscale}: "
            "take it with compute_inv_freq(..., with_mscale=True)")
    return inv_freq


def compute_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor,
                    mscale: float = 1.0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [T] int -> (cos, sin) each [T, rotary_dim//2] float32,
    times ``mscale``."""
    freqs = positions.float()[:, None] * inv_freq[None, :]
    if mscale == 1.0:
        return torch.cos(freqs), torch.sin(freqs)
    return torch.cos(freqs) * mscale, torch.sin(freqs) * mscale


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


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """GPT-J / DeepSeek rotary convention: pairs (x[2i], x[2i+1]) rotate by
    frequency i, in fp32 (the JAX package's ``rotary.py:206-216``). x: [T,
    heads, rot]; cos/sin: [T, rot//2]."""
    T, heads, rot = x.shape
    xf = x.float().reshape(T, heads, rot // 2, 2)
    x1, x2 = xf[..., 0], xf[..., 1]
    c, s = cos[:, None, :], sin[:, None, :]
    out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.reshape(T, heads, rot).to(x.dtype)
