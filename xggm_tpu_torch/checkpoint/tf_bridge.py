"""Google-research TensorFlow BERT checkpoints into the port (counterpart of
`xggm_tpu/checkpoint/tf_bridge.py`).

`read_tf_checkpoint` reads a checkpoint's variables (`bert/encoder/layer_N/
...`) with TensorFlow, which it imports only when called; `convert_tf_bert`
maps them onto the flat names of `models/lxmert.py::BertTextModel`, which
`checkpoint/torch_bridge.py::merge_into` then loads. TF dense kernels are
[in, out] already, as the flat names expect; the separate query, key and
value kernels are concatenated into the fused `qkv`.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


_DENSE = (("kernel", "kernel"), ("bias", "bias"))
_LN = (("gamma", "scale"), ("beta", "bias"))
# (TF name, flat name, leaves) of a layer's variables past the attention's
# query, key and value, in the order they are looked for
_LAYER_VARS = (("attention/output/dense", "attention/output/dense", _DENSE),
               ("attention/output/LayerNorm", "attention/output/LayerNorm",
                _LN),
               ("intermediate/dense", "mlp/intermediate", _DENSE),
               ("output/dense", "mlp/output", _DENSE),
               ("output/LayerNorm", "mlp/LayerNorm", _LN))


def read_tf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Every variable of the TF checkpoint at `path`, as numpy; raises
    ImportError where TensorFlow is not installed."""
    try:
        import tensorflow as tf
    except Exception as e:
        raise ImportError(
            "tensorflow is required to read TF checkpoints; convert the "
            "checkpoint to torch/.npz offline instead") from e

    reader = tf.train.load_checkpoint(path)
    return {name: reader.get_tensor(name)
            for name, _ in tf.train.list_variables(path)}


def convert_tf_bert(tf_vars: Dict[str, np.ndarray], num_layers: int = 12,
                    prefix: str = "bert/"
                    ) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """(flat BertTextModel parameters, the TF names looked for in vain)."""
    out: Dict[str, np.ndarray] = {}
    missing: List[str] = []

    def take(name):
        full = prefix + name
        if full in tf_vars:
            return tf_vars[full]
        missing.append(full)
        return None

    def put(path, val):
        if val is not None:
            out[path] = np.asarray(val)

    for table in ("word_embeddings", "position_embeddings",
                  "token_type_embeddings"):
        put(f"embeddings/{table}/embedding", take(f"embeddings/{table}"))
    put("embeddings/LayerNorm/scale", take("embeddings/LayerNorm/gamma"))
    put("embeddings/LayerNorm/bias", take("embeddings/LayerNorm/beta"))

    for i in range(num_layers):
        t = f"encoder/layer_{i}"
        o = f"layer_{i}"
        qkv_k = [take(f"{t}/attention/self/{n}/kernel")
                 for n in ("query", "key", "value")]
        qkv_b = [take(f"{t}/attention/self/{n}/bias")
                 for n in ("query", "key", "value")]
        if all(k is not None for k in qkv_k):
            out[f"{o}/attention/self/qkv/kernel"] = np.concatenate(qkv_k, 1)
        if all(b is not None for b in qkv_b):
            out[f"{o}/attention/self/qkv/bias"] = np.concatenate(qkv_b, 0)
        for tf_name, name, leaves in _LAYER_VARS:
            for tf_leaf, leaf in leaves:
                put(f"{o}/{name}/{leaf}", take(f"{t}/{tf_name}/{tf_leaf}"))

    put("pooler/dense/kernel", take("pooler/dense/kernel"))
    put("pooler/dense/bias", take("pooler/dense/bias"))
    return out, missing
