"""Model construction and weight loading.

Only dummy (seeded random) weights and the JAX package's parameter tree
(dense, quantized, sparse-MoE and Mamba-family) are ported; loading a
checkpoint from disk is not. With a quantization config, the dummy weights
are quantized on the fly layer by layer and W4 leaves are packed where the
JAX loader packs them (``quantization/loader.py``), so a ``params_from_jax``
tree of the JAX engine carries over leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from aphrodite_tpu_torch.config import LoadConfig, ModelConfig
from aphrodite_tpu_torch.models.llama import QuantWeight
from aphrodite_tpu_torch.models.registry import model_class
from aphrodite_tpu_torch.quantization.base import QuantizationConfig

# JAX per-layer leaves that the port fuses, in concatenation order, and
# those it takes as they are; the MLP's are optional (MoE layers have none).
_FUSED = {"w_qkv": ("wq", "wk", "wv"), "b_qkv": ("bq", "bk", "bv"),
          "w_gate_up": ("w_gate", "w_up")}
_DIRECT = ("input_norm", "wo", "post_norm", "w_down", "q_norm", "k_norm",
           "q_norm_flat", "k_norm_flat", "post_attn_norm", "pre_ffw_norm",
           "post_ffw_norm")
_REQUIRED = ("w_qkv", "input_norm", "wo", "post_norm")
# A MoE layer's leaves (``layers.<i>.moe.<name>``): the experts' and the
# shared expert's gate|up fused on N.
_MOE_FUSED = {"we_gate_up": ("we_gate", "we_up"),
              "ws_gate_up": ("ws_gate", "ws_up")}
_MOE_DIRECT = ("router", "we_down", "ws_down", "ws_route")
# A Mamba-family layer's leaves, taken as they are (Mamba-1: x_proj, dt_w,
# dt_b and the optional biases; Mamba-2: dt_bias and gated_norm_w).
_SSM_LEAVES = ("norm", "in_proj", "in_b", "conv_w", "conv_b", "x_proj",
               "dt_w", "dt_b", "dt_bias", "A_log", "D", "gated_norm_w",
               "out_proj", "out_b")
_SSM_REQUIRED = ("norm", "in_proj", "conv_w", "A_log", "D", "out_proj")


def create_model(model_config: ModelConfig, device: torch.device | str,
                 quant_config: Optional[QuantizationConfig] = None
                 ) -> nn.Module:
    return model_class(model_config.architecture)(
        model_config, device=device, quant_config=quant_config)


def load_model(model_config: ModelConfig, load_config: LoadConfig,
               device: torch.device | str,
               quant_config: Optional[QuantizationConfig] = None
               ) -> nn.Module:
    if load_config.load_format != "dummy":
        raise NotImplementedError(
            f"load_format={load_config.load_format!r}: only dummy weights "
            "are ported (checkpoint loading is not)")
    model = create_model(model_config, device, quant_config)
    gen = torch.Generator(device=device).manual_seed(model_config.seed)
    model.init_dummy_params(gen)
    return model


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _quant_leaves(name: str, parts: list) -> dict[str, np.ndarray]:
    """Quantized leaves of projections fused along N: every leaf
    concatenates on its last axis (groups run along K); one input_perm
    serves them all only when they share it."""
    keys = set(parts[0])
    if any(set(p) != keys for p in parts):
        raise ValueError(f"{name}: parts have different quantized leaves")
    out = {}
    for k in sorted(keys):
        arrs = [_np(p[k]) for p in parts]
        if k == "input_perm":
            if any(not np.array_equal(a, arrs[0]) for a in arrs):
                raise NotImplementedError(
                    f"{name}: fused projections with different desc_act "
                    "permutations")
            out[k] = arrs[0]
        else:
            out[k] = np.concatenate(arrs, axis=-1)
    if "qweight_packed" in out:  # the JAX loader stores the bytes as int8
        out["qweight_packed"] = out["qweight_packed"].view(np.uint8)
    return out


def _stack(layers: Mapping[str, Any], fused: dict, direct: tuple
           ) -> dict[str, Any]:
    """The leaves of a [L, ...] stack that are present, with the fused
    ones concatenated on their last axis (quantized leaves: dicts)."""
    stacked = {}
    for name in direct:
        if name in layers:
            leaf = layers[name]
            stacked[name] = (_quant_leaves(name, [leaf])
                             if isinstance(leaf, Mapping) else _np(leaf))
    for name, parts in fused.items():
        if name in layers:
            stacked[name] = _np(layers[name])
        elif all(p in layers for p in parts):
            vals = [layers[p] for p in parts]
            stacked[name] = (
                _quant_leaves(name, vals) if isinstance(vals[0], Mapping)
                else np.concatenate([_np(v) for v in vals], axis=-1))
    return stacked


def _ssm_params_from_jax(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    layers = tree["layers"]
    missing = [k for k in _SSM_REQUIRED if k not in layers]
    if missing:
        raise KeyError(f"JAX Mamba tree lacks {missing}")
    out = {"embed": _np(tree["embed"]), "final_norm": _np(tree["final_norm"])}
    if "lm_head" in tree:
        out["lm_head"] = _np(tree["lm_head"])
    for name in _SSM_LEAVES:
        if name in layers:
            for i, row in enumerate(_np(layers[name])):
                out[f"layers.{i}.{name}"] = row
    return out


def params_from_jax(tree: Mapping[str, Any],
                    layer_kinds: Optional[list[str]] = None
                    ) -> dict[str, np.ndarray]:
    """The JAX package's Llama/Qwen2, Gemma-family, sparse-MoE or
    Mamba-family parameter tree (leaves: numpy or any array convertible
    with ``np.asarray``) -> the port's state dict. Takes both the unmerged
    ``wq/wk/wv`` + ``w_gate/w_up`` tree and the fused ``w_qkv`` /
    ``w_gate_up`` tree of ``maybe_merge_params``, with or without q/k/v
    biases and QK norms. Gemma trees are always unfused and may hold
    Gemma-2's sandwich norms; their ``is_sliding`` flags are left out:
    they are no weight, and both packages derive them from the config.
    Quantized projections are dicts of leaves (``qweight`` or
    ``qweight_packed``, ``scales``, ``zeros``, ``input_perm``); they become
    ``layers.<i>.<name>.<leaf>``.

    MoE trees keep ``router``, ``we_*`` and ``ws_*`` stacks: beside the
    attention leaves under ``layers`` when every layer is MoE, or under
    ``moe`` (with the dense layers' ``w_*`` under ``dense_mlp``), indexed
    by position within their kind, for mixed stacks; those need the
    model's ``layer_kinds``. They become ``layers.<i>.moe.<name>``.

    Mamba-family trees (an ``A_log`` stack) keep their leaf names:
    ``layers.<name>[i]`` becomes ``layers.<i>.<name>``."""
    layers = tree["layers"]
    if "A_log" in layers:
        return _ssm_params_from_jax(tree)
    num_layers = _np(layers["input_norm"]).shape[0]
    out = {"embed": _np(tree["embed"]), "final_norm": _np(tree["final_norm"])}
    if "lm_head" in tree:
        if isinstance(tree["lm_head"], Mapping):
            raise NotImplementedError("a quantized lm_head is not ported")
        out["lm_head"] = _np(tree["lm_head"])
    everywhere = list(range(num_layers))
    # (leaves, [(port layer, row of the leaves)]) of each [L, ...] stack.
    stacks = [(_stack(layers, _FUSED, _DIRECT), "", everywhere)]
    if "moe" in tree:  # mixed dense/MoE stack
        if layer_kinds is None or len(layer_kinds) != num_layers:
            raise ValueError("a mixed dense/MoE tree needs the model's "
                             "layer_kinds")
        of_kind = {k: [i for i, kk in enumerate(layer_kinds) if kk == k]
                   for k in ("dense", "moe")}
        stacks += [(_stack(tree["dense_mlp"], _FUSED, _DIRECT), "",
                    of_kind["dense"]),
                   (_stack(tree["moe"], _MOE_FUSED, _MOE_DIRECT), ".moe",
                    of_kind["moe"])]
    elif "router" in layers:  # every layer is MoE
        stacks.append((_stack(layers, _MOE_FUSED, _MOE_DIRECT), ".moe",
                       everywhere))
    have = {name for leaves, sub, _ in stacks if not sub for name in leaves}
    missing = [k for k in _REQUIRED if k not in have]
    if "moe" not in tree and "router" not in layers:
        missing += [k for k in ("w_gate_up", "w_down") if k not in have]
    if missing:
        raise KeyError(f"JAX tree lacks {missing} (or their unfused parts)")
    for leaves, sub, rows in stacks:
        for name, arr in leaves.items():
            for j, i in enumerate(rows):
                prefix = f"layers.{i}{sub}.{name}"
                if isinstance(arr, dict):
                    for leaf, a in arr.items():
                        out[f"{prefix}.{leaf}"] = a[j]
                else:
                    out[prefix] = arr[j]
    return out


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr)  # writable, contiguous copy
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@torch.no_grad()
def load_params(model: nn.Module,
                state: Mapping[str, np.ndarray]) -> None:
    """Copy a full state dict into the model's parameters and quantized
    buffers (cast to their dtype and device); every one must be given,
    with its shape. An ``input_perm`` leaf is taken where given."""
    targets = model.state_dict(keep_vars=True)
    state = dict(state)
    for name in [n for n in state if n.endswith(".input_perm")]:
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        if not isinstance(owner, QuantWeight):
            raise KeyError(f"{name}: not a quantized projection")
        owner.input_perm = _to_tensor(state.pop(name)).long().to(
            owner.scales.device)
    missing = set(targets) - set(state)
    missing = {n for n in missing if not n.endswith(".input_perm")}
    extra = set(state) - set(targets)
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    for name, p in targets.items():
        if name not in state:
            continue
        t = _to_tensor(state[name])
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(p.shape)}")
        if t.dtype in (torch.int8, torch.uint8) and t.dtype != p.dtype:
            raise ValueError(f"{name}: dtype {t.dtype} != {p.dtype}")
        p.copy_(t.to(device=p.device, dtype=p.dtype))
