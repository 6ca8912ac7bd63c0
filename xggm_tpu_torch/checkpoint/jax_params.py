"""Carry the JAX package's parameters into the port.

The JAX package flattens its parameter tree into `{'/'-joined path: array}`,
the format `xggm_tpu/serving/artifact.py::_flatten` writes to `params.npz`
(bf16 leaves stored as uint16 bit patterns, their dtypes in `meta.json`).
The port keeps the same tree, so the mapping is by name: '/' becomes '.',
the per-layer lists `layer_i`, `r_layer_i`, `x_layer_i` become
`layer.i`, `r_layers.i`, `x_layers.i` (and the GGM's `gnn_i`, `conv_i`,
`proj_i`, `head_i`, `merge_i` become `gnn.i`, `conv.i`, `proj.i`,
`head.i`, `merge.i`), a Dense `kernel` [in, out] becomes `weight` [out,
in], LayerNorm `scale` and Embed `embedding` become `weight`, and an int8
artifact's `kernel_scale_int8` becomes `weight_scale`. GIN's `eps` and
GAT's `attn` [2F, 1] keep their names and shapes, as do the raw
parameters of the research-lineage modules (`weight` [in, out] of a Kipf
GCN layer `gcn_i`, `W` and `a`, `gain`, `smooth_param`, `centers`,
`covs`). A flax
`WeightNorm(Dense_k, feature_axes=None)` named `wn` keeps its scalar scale
under `wn/Dense_k/kernel/scale`: it becomes `wn.scale` of a module that
names its Dense in `dense_name`. The stacked encoder's
`encoder/lang_stack/layer/...`, `r_stack/layer/...` and `x_stack/layer/...`
(`stacked_layers`) become `encoder.lang_stack.layer....` and the like: a
stacked kernel [L, in, out] becomes a stacked weight [L, out, in], and the
stacked LayerNorm and bias leaves [L, n] keep their shape.

`to_jax_params` is the inverse: a port model's parameters under the JAX
package's flat names, in the order `jax.tree_util` flattens them. The
pretraining model's tree maps the same way: `lxrt/...`,
`lm_head/transform/...` and `lm_head/bias` (the decoder is tied to the
word table, so it has no weight of its own), `seq_relationship`,
`obj_head/transform/...`, `obj_head/decoder_{obj,attr,feat}` and
`answer_head/{fc1,ln,fc2}`.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from xggm_tpu_torch.ops.basic import Dense, Embedding, LayerNorm

# Top-level submodules of the JAX XGGMModel that only a training model holds;
# a serving model (and a serving artifact) has none of them.
GGM_SUBMODULES = frozenset({"generator", "encoder_adj", "node_fc",
                            "fusion_fc"})
_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
           "bias": "bias", "eps": "eps", "attn": "attn",
           "kernel_scale_int8": "weight_scale",
           "W": "W", "a": "a", "gain": "gain",
           "smooth_param": "smooth_param", "centers": "centers",
           "covs": "covs"}
_WN_DENSE = re.compile(r"^Dense_\d+$")
# a raw `weight` leaf is a Kipf GCN layer's (SpectralGCN's `gcn_i`) alone:
# under any other name `weight` is no JAX leaf
_KIPF_LAYER = re.compile(r"^gcn_\d+$")
_LAYER_LIST = re.compile(
    r"^(layer|r_layer|x_layer|gnn|conv|proj|head|merge)_(\d+)$")
_LIST_NAMES = {"layer": "layer", "r_layer": "r_layers", "x_layer": "x_layers",
               "gnn": "gnn", "conv": "conv", "proj": "proj", "head": "head",
               "merge": "merge"}
_JAX_LISTS = {v: k for k, v in _LIST_NAMES.items()}


# Parent-module markers of the leaves the model reads in float32
# (LayerNorms); every other kernel and bias is read in the compute dtype.
_LN_MARKERS = ("layernorm", "layer_norm")


def bf16_consumed(key: str) -> bool:
    """Whether the JAX parameter `key` ('/'-joined path) is one the model
    reads in the compute dtype, the JAX package's rule
    (`xggm_tpu/training/steps.py::_bf16_consumed`): a `kernel` or `bias`
    whose parent module's name holds no LayerNorm marker. The leaves it
    selects are the bf16 parameter shadow's and the bf16 leaves of an
    exported artifact."""
    parts = key.split("/")
    parent = parts[-2].lower() if len(parts) > 1 else ""
    return (parts[-1] in ("kernel", "bias")
            and not any(m in parent for m in _LN_MARKERS))


def bf16_bits_to_float32(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> the float32 values they encode (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def port_name(jax_key: str) -> str:
    """The port's state-dict key for a JAX parameter path. Raises KeyError
    on an unknown leaf."""
    parts = jax_key.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    *path, leaf = parts
    if (leaf == "scale" and len(path) >= 3 and path[-1] == "kernel"
            and _WN_DENSE.match(path[-2])):
        path, port_leaf = path[:-2], "scale"
    elif leaf == "weight" and path and _KIPF_LAYER.match(path[-1]):
        port_leaf = "weight"
    elif leaf in _LEAVES:
        port_leaf = _LEAVES[leaf]
    else:
        raise KeyError(f"JAX parameter {jax_key!r}: unknown leaf {leaf!r}")
    out = []
    for p in path:
        m = _LAYER_LIST.match(p)
        out.append(f"{_LIST_NAMES[m.group(1)]}.{m.group(2)}" if m else p)
    return ".".join(out + [port_leaf])


def from_jax_params(flat: Mapping[str, np.ndarray], model: nn.Module,
                    dtypes: Optional[Mapping[str, str]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Map a flat JAX parameter dict onto `model`'s state dict (float32 CPU
    tensors, int8 for an int8 kernel, ready for `load_state_dict`).

    `dtypes` gives each key's true dtype where a bf16 leaf arrives as its
    uint16 bits. The parameters of a GGM submodule that `model` does not hold
    (a serving model) are skipped; any other key without a counterpart in
    `model`, a shape mismatch, or a parameter of `model` left unfilled
    raises."""
    expected = model.state_dict()
    held = {n.split(".")[0] for n in expected}
    out: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        name = port_name(key)
        top = name.split(".")[0]
        if top in GGM_SUBMODULES and top not in held:
            continue
        if name not in expected:
            raise KeyError(f"JAX parameter {key!r} has no counterpart "
                           f"{name!r} in {type(model).__name__}")
        arr = np.asarray(arr)
        if dtypes is not None and dtypes.get(key) == "bfloat16":
            arr = bf16_bits_to_float32(arr)
        if key.endswith("/kernel"):
            arr = np.swapaxes(arr, -1, -2)
        if tuple(arr.shape) != tuple(expected[name].shape):
            raise ValueError(f"JAX parameter {key!r} {arr.shape} does not fit "
                             f"{name!r} {tuple(expected[name].shape)}")
        # an int8 kernel stays int8; every other leaf becomes float32
        out[name] = torch.tensor(arr, dtype=torch.int8 if arr.dtype == np.int8
                                 else torch.float32)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"{len(missing)} parameters of "
                       f"{type(model).__name__} have no JAX counterpart, "
                       f"e.g. {missing[:3]}")
    return out


def _jax_leaf(module: nn.Module, leaf: str) -> str:
    """The JAX leaf name of `module`'s entry `leaf`."""
    # an int8 Dense holds its per-channel scale beside the weight
    if leaf == "weight":
        if isinstance(module, Dense) or hasattr(module, "weight_scale"):
            return "kernel"
        if isinstance(module, LayerNorm):
            return "scale"
        if isinstance(module, Embedding):
            return "embedding"
    if leaf == "weight_scale":
        return "kernel_scale_int8"
    if leaf == "scale" and hasattr(module, "dense_name"):
        return f"{module.dense_name}/kernel/scale"
    return leaf


def jax_names(model: nn.Module) -> Dict[str, str]:
    """{state-dict key of `model`: its JAX path `params/...`}; raises for a
    key with no JAX name."""
    out = {}
    for name in model.state_dict():
        mod_path, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        module = model.get_submodule(mod_path)
        parts = mod_path.split(".") if mod_path else []
        path, i = [], 0
        while i < len(parts):
            if (parts[i] in _JAX_LISTS and i + 1 < len(parts)
                    and parts[i + 1].isdigit()):
                path.append(f"{_JAX_LISTS[parts[i]]}_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        key = "/".join(["params", *path, _jax_leaf(module, leaf)])
        if port_name(key) != name:
            raise KeyError(f"{name!r} has no JAX name (got {key!r})")
        out[name] = key
    return out


def to_jax_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """`model`'s state as `{'params/...' JAX path: numpy array}`, the keys,
    shapes and order of `xggm_tpu/serving/artifact.py::_flatten` for the
    same model (Dense kernels [in, out], stacked ones [L, in, out]; float32
    parameters as float32)."""
    out = {}
    names = jax_names(model)
    for name, t in model.state_dict().items():
        key = names[name]
        arr = t.detach().cpu().numpy()
        out[key] = np.ascontiguousarray(
            np.swapaxes(arr, -1, -2) if key.endswith("/kernel") else arr)
    # jax.tree_util flattens a dict in sorted key order, level by level
    return {k: out[k] for k in sorted(out, key=lambda k: k.split("/"))}
