"""Serving artifacts: export the port's own models, and serve artifacts of
either package (counterpart of `xggm_tpu/serving/artifact.py`).

An artifact directory holds `params.npz` (flat `{'/'-joined JAX path:
array}`, bf16 leaves as uint16 bits, int8 kernels as int8) and `meta.json`
(answer vocabulary, input shapes, dtypes, `param_dtypes`, `notes`). The JAX
package also writes `predict.stablehlo`, its compiled graph; the port
ignores it and rebuilds the model from the parameter shapes and keys.

`export_model` writes the JAX package's `params.npz` and `meta.json` for a
port model, key for key and bit for bit, but no `predict.stablehlo`: the
port has no JAX, so an artifact it exports is served by the port only. It
records the attention head count, which no parameter shape shows, under
`notes["num_attention_heads"]`; `ServingModel.load` reads it from there
when present, from its `config` otherwise.

`quantize="int8"` artifacts (either package's) are served with every
`Dense` that has an int8 kernel swapped for `serving.quant.Int8Dense`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from xggm_tpu_torch.checkpoint.jax_params import (
    GGM_SUBMODULES, bf16_bits_to_float32, from_jax_params, jax_names,
    port_name, to_jax_params)
from xggm_tpu_torch.config import (
    MAX_SEQ_LENGTH, NUM_OBJECTS, LxmertConfig, XGGMConfig, gqa_ood_config)
from xggm_tpu_torch.models.task_model import XGGMModel
from xggm_tpu_torch.ops.basic import Dense
from xggm_tpu_torch.serving.quant import (
    SCALE_KEY, Int8Dense, quantize_dense_params)
from xggm_tpu_torch.training.steps import bf16_param_shadow, make_logits_step
from xggm_tpu_torch.utils.device import resolve_device
from xggm_tpu_torch.utils.io import load_json

ARTIFACT_VERSION = 1
_PARAMS_FILE = "params.npz"
_META_FILE = "meta.json"
_LAYER = re.compile(r"^lxrt/encoder/(layer|r_layer|x_layer)_(\d+)/")
HEADS_NOTE = "num_attention_heads"


def _shadow_bits(t: torch.Tensor, key: str) -> np.ndarray:
    """A bf16 shadow leaf's uint16 bits in the JAX layout of `key` (a
    Dense kernel [in, out])."""
    bits = t.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    return np.ascontiguousarray(np.swapaxes(bits, -1, -2)
                                if key.endswith("/kernel") else bits)


def export_model(model: XGGMModel, path: str, *,
                 batch_size: Optional[int] = 16,
                 label2ans: Optional[List[str]] = None,
                 bf16_weights: bool = True, quantize: Optional[str] = None,
                 notes: Optional[dict] = None,
                 shadow: Optional[Mapping[str, torch.Tensor]] = None) -> str:
    """Write `model` (every parameter, the GGM parts included) as an
    artifact directory at `path`; returns `path`.

    With `bf16_weights` and a bf16 model, the leaves of the bf16 parameter
    shadow are stored in bfloat16, its bytes (`shadow`, a train state's,
    else `training/steps.py::bf16_param_shadow` of the model: the same
    rounding of the masters), as the JAX package's `_serve_params` overlays
    its shadow. `quantize="int8"` then quantizes the Dense kernels
    (`serving.quant.quantize_dense_params`), the bf16-rounded ones where
    there are. `batch_size` None: any batch size."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize mode {quantize!r}")
    flat = to_jax_params(model)
    bits = {}
    if bf16_weights and model.cfg.compute_dtype == torch.bfloat16:
        names = jax_names(model)
        for name, t in (shadow or bf16_param_shadow(model)).items():
            bits[names[name]] = _shadow_bits(t, names[name])
        for key, b in bits.items():
            flat[key] = bf16_bits_to_float32(b)
    bf16 = set(bits)
    if quantize == "int8":
        flat, n_q = quantize_dense_params(flat)
        if n_q == 0:
            raise ValueError("quantize='int8' found no Dense kernels")
        bf16 = {k for k in bf16 if flat[k].dtype != np.int8}
    dtypes = {k: "bfloat16" if k in bf16 else str(v.dtype)
              for k, v in flat.items()}
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, _PARAMS_FILE),
             **{k: bits[k] if k in bf16 else v for k, v in flat.items()})
    cfg = model.cfg
    meta = {
        "artifact_version": ARTIFACT_VERSION,
        "jax_version": None,
        "platforms": [],
        "batch_size": batch_size,
        "seq_len": MAX_SEQ_LENGTH,
        "num_objects": NUM_OBJECTS,
        "feat_dim": cfg.visual.visual_feat_dim,
        "feats_dtype": ("bfloat16" if cfg.compute_dtype == torch.bfloat16
                        else "float32"),
        "quantize": quantize,
        "num_answers": int(model.num_answers),
        "param_dtypes": dtypes,
        "label2ans": label2ans,
        "notes": {**(notes or {}),
                  HEADS_NOTE: cfg.bert.num_attention_heads},
    }
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return path


def _swap_int8_dense(model: XGGMModel, flat: Mapping[str, np.ndarray]
                     ) -> int:
    """Replace each `Dense` of `model` whose kernel `flat` holds in int8 by
    an `Int8Dense` of the same shape (filled by the state-dict load);
    returns the number swapped. The GGM submodules a serving model lacks
    are skipped; an int8 kernel on any other module type raises."""
    held = {n for n, _ in model.named_children()}
    n = 0
    for key in flat:
        if not key.endswith("/" + SCALE_KEY):
            continue
        name = port_name(key[:-len(SCALE_KEY)] + "kernel")[:-len(".weight")]
        if name.split(".")[0] in GGM_SUBMODULES - held:
            continue
        dense = model.get_submodule(name)
        if type(dense) is not Dense:
            raise ValueError(f"int8 kernel {key!r} on a "
                             f"{type(dense).__name__}, not a Dense")
        out_f, in_f = dense.weight.shape
        parent, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent), child, Int8Dense(
            in_f, out_f, dense.dtype, bias=dense.bias is not None,
            device=dense.weight.device))
        n += 1
    return n


def lxmert_config_from_params(flat: Mapping[str, np.ndarray], meta: dict,
                              base: LxmertConfig) -> Tuple[LxmertConfig, int]:
    """(encoder config, num_answers) with every width and layer count read
    from the parameter shapes and keys; the head count, LayerNorm eps and
    init range come from `base`, the compute dtype from the artifact's input
    feature dtype."""
    shapes = {re.sub(r"^params/", "", k): v.shape for k, v in flat.items()}
    vocab, hidden = shapes["lxrt/embeddings/word_embeddings/embedding"]
    counts = {"layer": set(), "r_layer": set(), "x_layer": set()}
    for key in shapes:
        m = _LAYER.match(key)
        if m:
            counts[m.group(1)].add(int(m.group(2)))
    inter = next(s[1] for k, s in shapes.items()
                 if k.startswith("lxrt/encoder/")
                 and k.endswith("/intermediate/kernel"))
    bert = dataclasses.replace(
        base.bert, vocab_size=vocab, hidden_size=hidden,
        intermediate_size=inter,
        max_position_embeddings=shapes[
            "lxrt/embeddings/position_embeddings/embedding"][0],
        type_vocab_size=shapes[
            "lxrt/embeddings/token_type_embeddings/embedding"][0])
    visual = dataclasses.replace(
        base.visual, l_layers=len(counts["layer"]),
        r_layers=len(counts["r_layer"]), x_layers=len(counts["x_layer"]),
        visual_feat_dim=shapes["lxrt/encoder/visn_fc/visn_fc/kernel"][0],
        visual_pos_dim=shapes["lxrt/encoder/visn_fc/box_fc/kernel"][0])
    dtype = "bfloat16" if meta["feats_dtype"] == "bfloat16" else "float32"
    cfg = base.replace(bert=bert, visual=visual, dtype=dtype)
    return cfg, shapes["logit_fc/fc2/kernel"][1]


class ServingModel:
    """A model ready to answer: `predict_logits` / `predict_answers` over
    numpy batches, run on the model's device."""

    def __init__(self, model: XGGMModel, meta: dict):
        self.model = model
        self.meta = meta
        self.device = next(model.parameters()).device
        self.batch_size: Optional[int] = meta["batch_size"]
        self.label2ans: Optional[List[str]] = meta.get("label2ans")
        self._logits = make_logits_step(model)

    @classmethod
    def load(cls, path: str, config: Optional[XGGMConfig] = None,
             device="cuda") -> "ServingModel":
        """Load an artifact written by either package's `export_model`,
        bf16, fp32 or int8. The head count comes from the artifact's notes,
        else from `config` (default `gqa_ood_config()`)."""
        dev = resolve_device(device)
        meta = load_json(os.path.join(path, _META_FILE))
        if meta["artifact_version"] != ARTIFACT_VERSION:
            raise ValueError(
                f"artifact version {meta['artifact_version']} != "
                f"{ARTIFACT_VERSION} supported by this build")
        if meta.get("quantize") not in (None, "int8"):
            raise ValueError(f"unsupported quantize mode {meta['quantize']!r}")
        with np.load(os.path.join(path, _PARAMS_FILE)) as raw:
            flat = {k: raw[k] for k in raw.files}
        base = (config or gqa_ood_config()).lxmert
        heads = (meta.get("notes") or {}).get(HEADS_NOTE)
        if heads is not None:
            base = base.replace(bert=dataclasses.replace(
                base.bert, num_attention_heads=heads))
        cfg, num_answers = lxmert_config_from_params(flat, meta, base)
        model = XGGMModel(cfg, num_answers, device=dev)
        if meta.get("quantize") == "int8":
            _swap_int8_dense(model, flat)
        model.load_state_dict(
            from_jax_params(flat, model, meta["param_dtypes"]))
        return cls(model, meta)

    def pad_batch(self, batch: Dict[str, np.ndarray]
                  ) -> Tuple[Dict[str, np.ndarray], int]:
        """Pad a ragged batch up to the exported static batch size by
        repeating the last row; returns (padded batch, number of valid
        rows)."""
        n = len(batch["input_ids"])
        if self.batch_size is None or n == self.batch_size:
            return batch, n
        if n > self.batch_size:
            raise ValueError(f"batch of {n} > exported batch_size "
                             f"{self.batch_size}; chunk it")
        pad = self.batch_size - n
        return {k: np.concatenate([v] + [v[-1:]] * pad, axis=0)
                for k, v in batch.items()}, n

    def predict_logits(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """batch: input_ids/input_mask/segment_ids [n, seq] integer,
        feats [n, 36, feat_dim], boxes [n, 36, 4] -> logits [n, A] fp32."""
        padded, n = self.pad_batch(batch)
        dev = self.device
        tensors = {k: torch.from_numpy(np.asarray(padded[k], np.int64)).to(dev)
                   for k in ("input_ids", "input_mask", "segment_ids")}
        for k in ("feats", "boxes"):
            tensors[k] = torch.from_numpy(
                np.asarray(padded[k], np.float32)).to(dev)
        return self._logits(tensors).cpu().numpy()[:n]

    def predict_answers(self, batch: Dict[str, np.ndarray]) -> List[str]:
        if self.label2ans is None:
            raise ValueError("artifact was exported without label2ans")
        ids = np.argmax(self.predict_logits(batch), axis=-1)
        return [self.label2ans[int(i)] for i in ids]
