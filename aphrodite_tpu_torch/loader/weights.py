"""Model construction and weight loading.

Only dummy (seeded random) weights and the JAX package's parameter tree
(dense, quantized, sparse-MoE, DeepSeek V2/V3, Mamba-family and
``FlexibleDecoder``) are ported; loading a
checkpoint from disk is not. With a quantization config, the dummy weights
are quantized on the fly layer by layer and W4 leaves are packed where the
JAX loader packs them (``quantization/loader.py``), so a ``params_from_jax``
tree of the JAX engine carries over leaf for leaf. ``realize_int4_leaves``
turns a loaded model's packed W4 leaves into the native-int4 layout, as
the JAX package's function of that name does to its tree.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from aphrodite_tpu_torch.config import LoadConfig, ModelConfig
from aphrodite_tpu_torch.models.llama import QuantWeight
from aphrodite_tpu_torch.models.registry import model_class
from aphrodite_tpu_torch.ops.quant_matmul import pack_int4, unpack_w4
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
# A FlexibleDecoder layer's leaves (``llama_variants.py:170-222``), named
# as in the JAX tree, Q/K/V and a gated MLP's gate/up fused on N; and the
# tree's top-level leaves.
_FLEX_FUSED = {"w_qkv": ("wq", "wk", "wv"), "b_qkv": ("bq", "bk", "bv"),
               "w_gate_up": ("w_gate", "w_up"),
               "b_gate_up": ("b_gate", "b_up")}
_FLEX_DIRECT = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "wo", "bo", "w_down",
                "b_down", "fc1_w", "fc1_b", "fc2_w", "fc2_b")
_FLEX_TOP = ("embed", "embed_ln_w", "embed_ln_b", "final_norm_w",
             "final_norm_b", "lm_head")
# A DeepSeek V2/V3 layer's MLA leaves (``deepseek.py:162-205`` of the JAX
# package), taken as they are but for the absorbed einsums' weights, which
# the port keeps for batched products over the heads: the JAX [R, nq, d]
# permuted to w_uk [nq, nope, R] and w_uv [nq, R, v].
_MLA_DIRECT = ("input_norm", "post_norm", "wkv_a", "kv_a_norm", "wo", "wq",
               "wq_a", "q_a_norm", "wq_b")
_MLA_PERMUTED = {"w_uk": (1, 2, 0), "w_uv": (1, 0, 2)}
_MLA_MOE_DIRECT = _MOE_DIRECT + ("router_bias",)
# A vision tower's layer leaves (``models/vision.py:67-78`` of the JAX
# package), taken as they are but for Q/K/V and their biases, fused on N.
_VISION_FUSED = {"w_qkv": ("wq", "wk", "wv"), "b_qkv": ("bq", "bk", "bv")}
_VISION_DIRECT = ("ln1_w", "ln1_b", "wo", "bo", "ln2_w", "ln2_b", "fc1_w",
                  "fc1_b", "fc2_w", "fc2_b")


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
    if "qweight4" in out:  # jnp.int4 [.., K, N] -> pack_int4 bytes
        q = out["qweight4"].astype(np.int8)
        out["qweight4"] = ((q[..., 0::2, :] & 0xF)
                           | ((q[..., 1::2, :] & 0xF) << 4)).astype(np.uint8)
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


def _flexible_params_from_jax(tree: Mapping[str, Any]
                              ) -> dict[str, np.ndarray]:
    layers = tree["layers"]
    known = set(_FLEX_DIRECT) | set(_FLEX_FUSED) | {
        p for parts in _FLEX_FUSED.values() for p in parts}
    unknown = sorted(set(layers) - known)
    if unknown:
        raise NotImplementedError(
            f"FlexibleDecoder leaves {unknown} are not ported yet "
            "(ROADMAP A13)")
    out = {k: _np(tree[k]) for k in _FLEX_TOP if k in tree}
    for name, arr in _stack(layers, _FLEX_FUSED, _FLEX_DIRECT).items():
        for i, row in enumerate(arr):
            out[f"layers.{i}.{name}"] = row
    return out


def _deepseek_params_from_jax(tree: Mapping[str, Any],
                              layer_kinds: Optional[list[str]]
                              ) -> dict[str, np.ndarray]:
    layers = tree["layers"]
    if any(isinstance(v, Mapping) for part in ("layers", "dense_mlp", "moe")
           for v in tree.get(part, {}).values()):
        raise NotImplementedError("a quantized DeepSeek tree: quantized "
                                  "DeepSeek is not ported (ROADMAP A10)")
    num_layers = _np(layers["input_norm"]).shape[0]
    if layer_kinds is None or len(layer_kinds) != num_layers:
        raise ValueError("a DeepSeek tree needs the model's layer_kinds")
    out = {k: _np(tree[k]) for k in ("embed", "final_norm", "lm_head")
           if k in tree}
    leaves = {k: _np(layers[k]) for k in _MLA_DIRECT if k in layers}
    leaves.update({k: _np(layers[k]).transpose(0, *(a + 1 for a in perm))
                   for k, perm in _MLA_PERMUTED.items()})
    for name, arr in leaves.items():
        for i, row in enumerate(arr):
            out[f"layers.{i}.{name}"] = row
    for part, sub, fused, direct in (
            ("dense_mlp", "", _FUSED, _DIRECT),
            ("moe", ".moe", _MOE_FUSED, _MLA_MOE_DIRECT)):
        rows = [i for i, k in enumerate(layer_kinds)
                if k == part.split("_")[0]]
        for name, arr in _stack(tree.get(part, {}), fused, direct).items():
            for j, i in enumerate(rows):
                out[f"layers.{i}{sub}.{name}"] = arr[j]
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
    Quantized projections are dicts of leaves (``qweight``,
    ``qweight_packed`` or the realized ``qweight4``, ``scales``, ``zeros``,
    ``input_perm``; fp8's ``qweight`` in ml_dtypes' float8_e4m3fn with
    ``weight_scale``, and a checkpoint's ``weight_scale_block`` and
    ``input_scale``); they become ``layers.<i>.<name>.<leaf>``, a
    ``qweight4`` packed as ``ops.quant_matmul.pack_int4`` bytes.

    MoE trees keep ``router``, ``we_*`` and ``ws_*`` stacks: beside the
    attention leaves under ``layers`` when every layer is MoE, or under
    ``moe`` (with the dense layers' ``w_*`` under ``dense_mlp``), indexed
    by position within their kind, for mixed stacks; those need the
    model's ``layer_kinds``. They become ``layers.<i>.moe.<name>``.

    DeepSeek V2/V3 trees (a ``wkv_a`` stack; the model's ``layer_kinds``)
    keep their MLA leaves under ``layers.<i>``, ``w_uk`` and ``w_uv``
    permuted to the port's [nq, ., .] layouts, the ``dense_mlp`` and
    ``moe`` stacks as the mixed MoE trees', V3's ``router_bias`` too.

    Mamba-family trees (an ``A_log`` stack) keep their leaf names:
    ``layers.<name>[i]`` becomes ``layers.<i>.<name>``; so do
    ``FlexibleDecoder`` trees (an ``ln1_w`` stack: BLOOM, MPT, Falcon,
    Baichuan), but for Q/K/V and gate/up, fused as ``w_qkv`` / ``b_qkv``
    and ``w_gate_up`` / ``b_gate_up``, and its top-level ``embed``,
    ``embed_ln_w/b``, ``final_norm_w/b`` and ``lm_head``.

    A vision model's tree (Gemma-3 MM, PaliGemma) adds ``vision`` (the
    tower: top-level leaves as they are, its ``layers`` stacks with Q/K/V
    fused) and ``projector``; they become ``vision.<name>``,
    ``vision.layers.<name>`` and ``projector.<name>``."""
    out = _text_params_from_jax(tree, layer_kinds)
    if "vision" in tree:
        vision = tree["vision"]
        out.update({f"vision.{k}": _np(v) for k, v in vision.items()
                    if k != "layers"})
        out.update({f"vision.layers.{k}": v for k, v in _stack(
            vision["layers"], _VISION_FUSED, _VISION_DIRECT).items()})
        out.update({f"projector.{k}": _np(v)
                    for k, v in tree["projector"].items()})
    return out


def _text_params_from_jax(tree: Mapping[str, Any],
                          layer_kinds: Optional[list[str]]
                          ) -> dict[str, np.ndarray]:
    layers = tree["layers"]
    if "wkv_a" in layers:
        return _deepseek_params_from_jax(tree, layer_kinds)
    if "A_log" in layers:
        return _ssm_params_from_jax(tree)
    if "ln1_w" in layers:
        return _flexible_params_from_jax(tree)
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


@torch.no_grad()
def realize_int4_leaves(model: nn.Module) -> nn.Module:
    """The JAX package's ``loader/weights.py:realize_int4_leaves`` on a
    loaded model, in place: each ``qweight_packed`` leaf (uint8 global-half
    nibbles [K/2, N]) becomes a ``qweight4`` leaf holding ``q - 8`` in the
    signed int4 range, stored as ``pack_int4`` bytes [K/2, N], and its zeros
    become ``z - 8``, so ``(q - z) * s`` is unchanged. Every conversion runs
    on the leaf's own device; leaves that are not packed stay as they are.
    The JAX loader applies it only on a single TPU, so here it is the
    caller's choice; returns the model."""
    for mod in model.modules():
        if isinstance(mod, QuantWeight) and \
                getattr(mod, "qweight_packed", None) is not None:
            q4 = pack_int4(unpack_w4(mod.qweight_packed) - 8)
            del mod.qweight_packed
            mod.register_buffer("qweight4", q4)
            mod.zeros.sub_(8.0)
    return model


# ml_dtypes' types (JAX's bf16 and fp8 arrays), by name: viewed as their
# bytes and then as torch's type, so that no ml_dtypes import is needed.
_ML_DTYPES = {"bfloat16": (np.uint16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
              "float8_e5m2": (np.uint8, torch.float8_e5m2)}


# Leaves a quantized projection takes only where a loaded tree gives them.
_OPTIONAL_LEAVES = (".input_perm", ".weight_scale_block", ".input_scale")


def _to_tensor(arr) -> torch.Tensor:
    """A leaf given as a numpy array (ml_dtypes' bf16 and fp8 included) or
    a tensor (another model's state dict: numpy has no fp8), as a CPU
    tensor of its own dtype."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().contiguous()
    arr = np.array(arr)  # writable, contiguous copy
    if arr.dtype.name in _ML_DTYPES:
        bits, dtype = _ML_DTYPES[arr.dtype.name]
        return torch.from_numpy(arr.view(bits)).view(dtype)
    return torch.from_numpy(arr)


@torch.no_grad()
def load_params(model: nn.Module, state: Mapping[str, Any]) -> None:
    """Copy a full state dict into the model's parameters and quantized
    buffers (cast to their dtype and device; fp8 and integer leaves must
    come in their own dtype and are copied bit for bit); every one must be
    given, with its shape. The optional leaves ``input_perm`` (W4) and
    ``weight_scale_block`` / ``input_scale`` (fp8) are taken where given."""
    targets = model.state_dict(keep_vars=True)
    state = dict(state)
    for name in [n for n in state if n.endswith(_OPTIONAL_LEAVES)]:
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        leaf = name.rsplit(".", 1)[1]
        if not isinstance(owner, QuantWeight) or not hasattr(owner, leaf):
            raise KeyError(f"{name}: not a leaf of this quantized "
                           "projection")
        t = _to_tensor(state.pop(name)).to(owner.device)
        setattr(owner, leaf, t.long() if leaf == "input_perm" else t.float())
    missing = set(targets) - set(state)
    missing = {n for n in missing if not n.endswith(_OPTIONAL_LEAVES)}
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
        if p.dtype.itemsize == 1 or t.dtype.itemsize == 1:
            if t.dtype != p.dtype:
                raise ValueError(f"{name}: dtype {t.dtype} != {p.dtype}")
            # bytes, not values: an fp8 leaf lands bit for bit
            p.view(torch.uint8).copy_(t.view(torch.uint8).to(p.device))
            continue
        p.copy_(t.to(device=p.device, dtype=p.dtype))
