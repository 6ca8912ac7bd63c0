"""Carry the JAX package's parameters into the port.

The JAX package flattens its parameter tree into `{'/'-joined path: array}`,
the format `xggm_tpu/serving/artifact.py::_flatten` writes to `params.npz`
(bf16 leaves stored as uint16 bit patterns, their dtypes in `meta.json`).
The port keeps the same tree, so the mapping is by name: '/' becomes '.',
the per-layer lists `layer_i`, `r_layer_i`, `x_layer_i` become
`layer.i`, `r_layers.i`, `x_layers.i` (and the GGM's `gnn_i`, `conv_i`,
`proj_i` become `gnn.i`, `conv.i`, `proj.i`), a Dense `kernel` [in, out]
becomes `weight` [out, in], and LayerNorm `scale` and Embed `embedding`
become `weight`.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

# Top-level submodules of the JAX XGGMModel that only a training model holds;
# a serving model (and a serving artifact) has none of them.
GGM_SUBMODULES = frozenset({"generator", "encoder_adj", "node_fc",
                            "fusion_fc"})
_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
           "bias": "bias"}
_LAYER_LIST = re.compile(r"^(layer|r_layer|x_layer|gnn|conv|proj)_(\d+)$")
_LIST_NAMES = {"layer": "layer", "r_layer": "r_layers", "x_layer": "x_layers",
               "gnn": "gnn", "conv": "conv", "proj": "proj"}


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
    if leaf not in _LEAVES:
        raise KeyError(f"JAX parameter {jax_key!r}: unknown leaf {leaf!r}")
    out = []
    for p in path:
        m = _LAYER_LIST.match(p)
        out.append(f"{_LIST_NAMES[m.group(1)]}.{m.group(2)}" if m else p)
    return ".".join(out + [_LEAVES[leaf]])


def from_jax_params(flat: Mapping[str, np.ndarray], model: nn.Module,
                    dtypes: Optional[Mapping[str, str]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Map a flat JAX parameter dict onto `model`'s state dict (float32 CPU
    tensors, ready for `load_state_dict`).

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
            arr = arr.T
        if tuple(arr.shape) != tuple(expected[name].shape):
            raise ValueError(f"JAX parameter {key!r} {arr.shape} does not fit "
                             f"{name!r} {tuple(expected[name].shape)}")
        out[name] = torch.tensor(arr, dtype=torch.float32)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"{len(missing)} parameters of "
                       f"{type(model).__name__} have no JAX counterpart, "
                       f"e.g. {missing[:3]}")
    return out
