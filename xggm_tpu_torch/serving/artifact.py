"""Serve an artifact exported by the JAX package (counterpart of
`xggm_tpu/serving/artifact.py::ServingModel`).

An artifact directory holds `params.npz` (flat `{'/'-joined path: array}`,
bf16 leaves as uint16 bits), `meta.json` (answer vocabulary, input shapes,
dtypes) and `predict.stablehlo`, the JAX graph, which the port ignores: it
rebuilds the model from the parameter shapes and keys and runs it in PyTorch.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from xggm_tpu_torch.checkpoint.jax_params import from_jax_params
from xggm_tpu_torch.config import LxmertConfig, XGGMConfig, gqa_ood_config
from xggm_tpu_torch.models.task_model import XGGMModel
from xggm_tpu_torch.training.steps import make_logits_step
from xggm_tpu_torch.utils.device import resolve_device
from xggm_tpu_torch.utils.io import load_json

ARTIFACT_VERSION = 1
_PARAMS_FILE = "params.npz"
_META_FILE = "meta.json"
_LAYER = re.compile(r"^lxrt/encoder/(layer|r_layer|x_layer)_(\d+)/")


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
        """Load an artifact written by the JAX package's `export_model`.
        `config` supplies what the parameters do not show (the head count);
        it defaults to `gqa_ood_config()`."""
        dev = resolve_device(device)
        meta = load_json(os.path.join(path, _META_FILE))
        if meta["artifact_version"] != ARTIFACT_VERSION:
            raise ValueError(
                f"artifact version {meta['artifact_version']} != "
                f"{ARTIFACT_VERSION} supported by this build")
        if meta.get("quantize"):
            raise NotImplementedError(
                f"quantize={meta['quantize']!r} artifacts are not served by "
                "the PyTorch port yet (int8 serving is queued in ROADMAP.md)")
        with np.load(os.path.join(path, _PARAMS_FILE)) as raw:
            flat = {k: raw[k] for k in raw.files}
        base = (config or gqa_ood_config()).lxmert
        cfg, num_answers = lxmert_config_from_params(flat, meta, base)
        model = XGGMModel(cfg, num_answers, device=dev)
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
