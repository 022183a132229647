"""Model construction and weight loading.

Only dummy (seeded random) weights and the JAX package's parameter tree are
ported; loading a checkpoint from disk is not.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from aphrodite_tpu_torch.config import LoadConfig, ModelConfig
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM, model_class

# JAX per-layer leaves that the port fuses, in concatenation order.
_FUSED = {"w_qkv": ("wq", "wk", "wv"), "b_qkv": ("bq", "bk", "bv"),
          "w_gate_up": ("w_gate", "w_up")}
_DIRECT = ("input_norm", "wo", "post_norm", "w_down")


def create_model(model_config: ModelConfig,
                 device: torch.device | str) -> LlamaForCausalLM:
    return model_class(model_config.architecture)(model_config, device=device)


def load_model(model_config: ModelConfig, load_config: LoadConfig,
               device: torch.device | str) -> LlamaForCausalLM:
    if load_config.load_format != "dummy":
        raise NotImplementedError(
            f"load_format={load_config.load_format!r}: only dummy weights "
            "are ported (checkpoint loading is not)")
    model = create_model(model_config, device)
    gen = torch.Generator(device=device).manual_seed(model_config.seed)
    model.init_dummy_params(gen)
    return model


def _np(x) -> np.ndarray:
    return np.asarray(x)


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """The JAX package's Llama/Qwen2 parameter tree (leaves: numpy or any
    array convertible with ``np.asarray``) -> the port's state dict. Takes
    both the unmerged ``wq/wk/wv`` + ``w_gate/w_up`` tree and the fused
    ``w_qkv`` / ``w_gate_up`` tree of ``maybe_merge_params``, with or
    without q/k/v biases."""
    layers = tree["layers"]
    num_layers = _np(layers["input_norm"]).shape[0]
    out = {"embed": _np(tree["embed"]), "final_norm": _np(tree["final_norm"])}
    if "lm_head" in tree:
        out["lm_head"] = _np(tree["lm_head"])
    stacked = {}
    for name in _DIRECT:
        stacked[name] = _np(layers[name])
    for fused, parts in _FUSED.items():
        if fused in layers:
            stacked[fused] = _np(layers[fused])
        elif all(p in layers for p in parts):
            stacked[fused] = np.concatenate([_np(layers[p]) for p in parts],
                                            axis=-1)
        elif fused != "b_qkv":
            raise KeyError(f"JAX tree has neither {fused} nor {parts}")
    for name, arr in stacked.items():
        for i in range(num_layers):
            out[f"layers.{i}.{name}"] = arr[i]
    return out


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr)  # writable, contiguous copy
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@torch.no_grad()
def load_params(model: LlamaForCausalLM,
                state: Mapping[str, np.ndarray]) -> None:
    """Copy a full state dict into the model's parameters (cast to their
    dtype and device); every parameter must be given, with its shape."""
    params = dict(model.named_parameters())
    missing = set(params) - set(state)
    extra = set(state) - set(params)
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    for name, p in params.items():
        t = _to_tensor(state[name])
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(p.shape)}")
        p.copy_(t.to(device=p.device, dtype=p.dtype))
