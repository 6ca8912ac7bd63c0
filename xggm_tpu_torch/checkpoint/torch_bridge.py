"""Reference torch checkpoints into the port (a copy, without JAX, of what
the loaders need from `xggm_tpu/checkpoint/torch_bridge.py`).

The reference saves LXMERT snapshots (`{name}_LXRT.pth`, keys `bert.*` and
`answer_head.*`) and task models (`lxrt_encoder.model.bert.*`, `logit_fc.*`,
the GGM modules) as torch state dicts. The converters map them onto the JAX
package's flat parameter names (`lxrt/encoder/layer_0/...`, Dense kernels
[in, out]), exactly as the JAX package does, so both packages read a
snapshot alike:

* `.module` DataParallel prefixes are stripped, TF-style `gamma`/`beta`
  LayerNorm names become `weight`/`bias`;
* the separate q/k/v linears of a self-attention are concatenated into one
  `qkv` projection, the cross-attention's k/v into one `kv`, since the port
  keeps the JAX package's parameter tree.

`convert_pretrain_model` does the same for a reference pretraining model
(`LXRTPretraining`: the encoder and the four pretraining heads). With
`cfg.stacked_layers` the encoder's per-layer paths are stacked into the
`lang_stack` / `r_stack` / `x_stack` [L, ...] layout (`stack_encoder_flat`;
`unstack_encoder_flat` is its inverse), as the JAX package does.

`merge_into` then puts such a flat dict onto a port model: the names and
transposes of `checkpoint/jax_params.py`, the model's other parameters left
as they are; a tensor-parallel Dense (`parallel/tensor.py`) takes its
rank's slice of the whole tensor. The answer-head surgery of `--loadLXMERTQA` is in
`checkpoint/answer_table.py`.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from xggm_tpu_torch.checkpoint.jax_params import port_name
from xggm_tpu_torch.config import LxmertConfig
from xggm_tpu_torch.parallel.tensor import local_slice


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A .pth state dict (or a pickled module's) as numpy arrays."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in obj.items()}


def strip_prefixes(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Strip DataParallel prefixes and rename gamma/beta to weight/bias."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        k = k.replace(".module.", ".")
        if k.endswith(".gamma"):
            k = k[: -len("gamma")] + "weight"
        elif k.endswith(".beta"):
            k = k[: -len("beta")] + "bias"
        out[k] = v
    return out


class _Mapper:
    """Collects {JAX flat name: array} and the torch keys it looked for in
    vain."""

    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = sd
        self.out: Dict[str, np.ndarray] = {}
        self.missing: List[str] = []

    def _take(self, key: str) -> Optional[np.ndarray]:
        if key in self.sd:
            return self.sd[key]
        self.missing.append(key)
        return None

    def linear(self, tkey: str, opath: str):
        w = self._take(f"{tkey}.weight")
        b = self._take(f"{tkey}.bias")
        if w is not None:
            self.out[f"{opath}/kernel"] = np.ascontiguousarray(w.T)
        if b is not None:
            self.out[f"{opath}/bias"] = b

    def linear_nobias(self, tkey: str, opath: str):
        w = self._take(f"{tkey}.weight")
        if w is not None:
            self.out[f"{opath}/kernel"] = np.ascontiguousarray(w.T)

    def fused_linear(self, tkeys: List[str], opath: str):
        """Several torch linears as one fused projection."""
        ws = [self._take(f"{t}.weight") for t in tkeys]
        bs = [self._take(f"{t}.bias") for t in tkeys]
        if all(w is not None for w in ws):
            self.out[f"{opath}/kernel"] = np.concatenate(
                [np.ascontiguousarray(w.T) for w in ws], axis=1)
        if all(b is not None for b in bs):
            self.out[f"{opath}/bias"] = np.concatenate(bs, axis=0)

    def layernorm(self, tkey: str, opath: str):
        w = self._take(f"{tkey}.weight")
        b = self._take(f"{tkey}.bias")
        if w is not None:
            self.out[f"{opath}/scale"] = w
        if b is not None:
            self.out[f"{opath}/bias"] = b

    def embedding(self, tkey: str, opath: str):
        w = self._take(f"{tkey}.weight")
        if w is not None:
            self.out[f"{opath}/embedding"] = w


def _map_bert_layer(m: _Mapper, t: str, o: str):
    m.fused_linear([f"{t}.attention.self.query", f"{t}.attention.self.key",
                    f"{t}.attention.self.value"], f"{o}/attention/self/qkv")
    m.linear(f"{t}.attention.output.dense", f"{o}/attention/output/dense")
    m.layernorm(f"{t}.attention.output.LayerNorm",
                f"{o}/attention/output/LayerNorm")
    m.linear(f"{t}.intermediate.dense", f"{o}/mlp/intermediate")
    m.linear(f"{t}.output.dense", f"{o}/mlp/output")
    m.layernorm(f"{t}.output.LayerNorm", f"{o}/mlp/LayerNorm")


def _map_self_att(m: _Mapper, t: str, o: str):
    m.fused_linear([f"{t}.self.query", f"{t}.self.key", f"{t}.self.value"],
                   f"{o}/self/qkv")
    m.linear(f"{t}.output.dense", f"{o}/output/dense")
    m.layernorm(f"{t}.output.LayerNorm", f"{o}/output/LayerNorm")


def _map_x_layer(m: _Mapper, t: str, o: str):
    m.linear(f"{t}.visual_attention.att.query",
             f"{o}/visual_attention/att/query")
    m.fused_linear([f"{t}.visual_attention.att.key",
                    f"{t}.visual_attention.att.value"],
                   f"{o}/visual_attention/att/kv")
    m.linear(f"{t}.visual_attention.output.dense",
             f"{o}/visual_attention/output/dense")
    m.layernorm(f"{t}.visual_attention.output.LayerNorm",
                f"{o}/visual_attention/output/LayerNorm")
    _map_self_att(m, f"{t}.lang_self_att", f"{o}/lang_self_att")
    _map_self_att(m, f"{t}.visn_self_att", f"{o}/visn_self_att")
    m.linear(f"{t}.lang_inter.dense", f"{o}/lang_mlp/intermediate")
    m.linear(f"{t}.lang_output.dense", f"{o}/lang_mlp/output")
    m.layernorm(f"{t}.lang_output.LayerNorm", f"{o}/lang_mlp/LayerNorm")
    m.linear(f"{t}.visn_inter.dense", f"{o}/visn_mlp/intermediate")
    m.linear(f"{t}.visn_output.dense", f"{o}/visn_mlp/output")
    m.layernorm(f"{t}.visn_output.LayerNorm", f"{o}/visn_mlp/LayerNorm")


_STACK_GROUPS = (
    # (per-layer path prefix, stacked path, layer-count attribute)
    ("x_layer", "x_stack", "x_layers"),
    ("r_layer", "r_stack", "r_layers"),
    ("layer", "lang_stack", "l_layers"),
)


def stack_encoder_flat(flat: Dict[str, np.ndarray], cfg: LxmertConfig,
                       our_prefix: str = "lxrt") -> Dict[str, np.ndarray]:
    """Per-layer encoder paths -> the stacked layout: every
    `{p}/encoder/layer_{i}/REST` (i = 0..L-1) becomes one
    `{p}/encoder/lang_stack/layer/REST` array with a leading [L] axis (and
    `r_layer` -> `r_stack`, `x_layer` -> `x_stack`). A group missing one
    layer's tensor is dropped with its per-layer keys, so that loading
    reports the stacked name unmatched rather than a ragged stack."""
    pat = re.compile(rf"^{re.escape(our_prefix)}/encoder/"
                     r"(x_layer|r_layer|layer)_(\d+)/(.*)$")
    lengths = {p: getattr(cfg.visual, attr) for p, _, attr in _STACK_GROUPS}
    stack_name = {p: s for p, s, _ in _STACK_GROUPS}
    out: Dict[str, np.ndarray] = {}
    per: Dict[Tuple[str, str], Dict[int, np.ndarray]] = {}
    for k, v in flat.items():
        mm = pat.match(k)
        if not mm:
            out[k] = v
            continue
        kind, idx, rest = mm.group(1), int(mm.group(2)), mm.group(3)
        per.setdefault((kind, rest), {})[idx] = v
    for (kind, rest), d in per.items():
        n = lengths[kind]
        if sorted(d) != list(range(n)):
            continue
        out[f"{our_prefix}/encoder/{stack_name[kind]}/layer/{rest}"] = \
            np.stack([d[i] for i in range(n)])
    return out


def unstack_encoder_flat(flat: Dict[str, np.ndarray], cfg: LxmertConfig,
                         our_prefix: str = "lxrt") -> Dict[str, np.ndarray]:
    """The inverse of `stack_encoder_flat`: each stacked [L, ...] leaf split
    into its per-layer `layer_{i}` paths."""
    pat = re.compile(rf"^{re.escape(our_prefix)}/encoder/"
                     r"(x_stack|r_stack|lang_stack)/layer/(.*)$")
    layer_name = {s: p for p, s, _ in _STACK_GROUPS}
    out: Dict[str, np.ndarray] = {}
    for k, v in flat.items():
        mm = pat.match(k)
        if not mm:
            out[k] = v
            continue
        stack, rest = mm.group(1), mm.group(2)
        for i in range(v.shape[0]):
            out[f"{our_prefix}/encoder/{layer_name[stack]}_{i}/{rest}"] = v[i]
    return out


def convert_lxrt_bert(sd: Dict[str, np.ndarray], cfg: LxmertConfig,
                      torch_prefix: str = "", our_prefix: str = "lxrt"
                      ) -> Tuple[Dict[str, np.ndarray], _Mapper]:
    """A torch LXRTModel state dict (`embeddings.*`, `encoder.*`, `pooler.*`
    under `torch_prefix`) as the encoder's flat JAX names; with
    `cfg.stacked_layers` the per-layer tensors are stacked into the
    [L, ...] layout."""
    m = _Mapper(sd)
    t = torch_prefix
    o = our_prefix

    m.embedding(f"{t}embeddings.word_embeddings",
                f"{o}/embeddings/word_embeddings")
    m.embedding(f"{t}embeddings.position_embeddings",
                f"{o}/embeddings/position_embeddings")
    m.embedding(f"{t}embeddings.token_type_embeddings",
                f"{o}/embeddings/token_type_embeddings")
    m.layernorm(f"{t}embeddings.LayerNorm", f"{o}/embeddings/LayerNorm")

    m.linear(f"{t}encoder.visn_fc.visn_fc", f"{o}/encoder/visn_fc/visn_fc")
    m.layernorm(f"{t}encoder.visn_fc.visn_layer_norm",
                f"{o}/encoder/visn_fc/visn_layer_norm")
    m.linear(f"{t}encoder.visn_fc.box_fc", f"{o}/encoder/visn_fc/box_fc")
    m.layernorm(f"{t}encoder.visn_fc.box_layer_norm",
                f"{o}/encoder/visn_fc/box_layer_norm")

    v = cfg.visual
    for i in range(v.l_layers):
        _map_bert_layer(m, f"{t}encoder.layer.{i}", f"{o}/encoder/layer_{i}")
    for i in range(v.r_layers):
        _map_bert_layer(m, f"{t}encoder.r_layers.{i}",
                        f"{o}/encoder/r_layer_{i}")
    for i in range(v.x_layers):
        _map_x_layer(m, f"{t}encoder.x_layers.{i}", f"{o}/encoder/x_layer_{i}")

    m.linear(f"{t}pooler.dense", f"{o}/pooler/dense")
    if cfg.stacked_layers:
        m.out = stack_encoder_flat(m.out, cfg, our_prefix=o)
    return m.out, m


def _map_linear_gelu_ln(m: _Mapper, t: str, o: str):
    """torch Sequential(Linear, GeLU, LayerNorm) -> {fc, ln}."""
    m.linear(f"{t}.0", f"{o}/fc")
    m.layernorm(f"{t}.2", f"{o}/ln")


def _map_gcn(m: _Mapper, t: str, o: str, n_convs: int):
    for j in range(n_convs):
        m.linear_nobias(f"{t}.gnn_layers.{j}.ctx_layer",
                        f"{o}/conv_{j}/ctx_layer")
        m.layernorm(f"{t}.gnn_layers.{j}.layer_norm",
                    f"{o}/conv_{j}/layer_norm")
    for j in range(n_convs + 1):
        _map_linear_gelu_ln(m, f"{t}.linear_prediction.{j}", f"{o}/proj_{j}")


def _map_gin(m: _Mapper, t: str, o: str, n_convs: int):
    for j in range(n_convs):
        eps = m._take(f"{t}.gnn_convs.{j}.eps")
        if eps is not None:
            m.out[f"{o}/conv_{j}/eps"] = eps
        _map_linear_gelu_ln(m, f"{t}.gnn_convs.{j}.linear",
                            f"{o}/conv_{j}/linear")
    for j in range(n_convs + 1):
        _map_linear_gelu_ln(m, f"{t}.linear_prediction.{j}", f"{o}/proj_{j}")


def _map_gat(m: _Mapper, t: str, o: str, n_heads: int):
    """torch {t}.gat_layers.{h}.{linear_layer, attn_layer}; the attention
    weight [1, 2F] becomes `attn` [2F, 1]. The reference has no merge
    projection: `merge_i` is left as it is."""
    for h in range(n_heads):
        th, oh = f"{t}.gat_layers.{h}", f"{o}/head_{h}"
        m.linear_nobias(f"{th}.linear_layer", f"{oh}/linear_layer")
        w = m._take(f"{th}.attn_layer.weight")
        if w is not None:
            m.out[f"{oh}/attn"] = np.ascontiguousarray(w.T)


def convert_task_model(sd: Dict[str, np.ndarray], cfg: LxmertConfig,
                       gnn: str = "GCN", n_layers: int = 2,
                       gat_heads: int = 2) -> Dict[str, np.ndarray]:
    """A reference task-model state dict (the GQA and VQA models' keys) as
    the XGGMModel's flat JAX names: the encoder, the answer head, the GGM
    glue and the generator `gnn` names (GCN, GIN or GAT with `gat_heads`
    heads)."""
    if gnn not in ("GCN", "GIN", "GAT"):
        raise ValueError(gnn)
    sd = strip_prefixes(sd)
    _, m = convert_lxrt_bert(sd, cfg, torch_prefix="lxrt_encoder.model.bert.",
                             our_prefix="lxrt")
    # answer head: Sequential(Linear, GeLU, LayerNorm, Linear)
    m.linear("logit_fc.0", "logit_fc/fc1")
    m.layernorm("logit_fc.2", "logit_fc/ln")
    m.linear("logit_fc.3", "logit_fc/fc2")
    # GGM glue
    m.linear("encoder_adj.0", "encoder_adj")
    _map_linear_gelu_ln(m, "node_fc", "node_fc")
    _map_linear_gelu_ln(m, "fusion_fc", "fusion_fc")
    for i in range(n_layers):
        t, o = f"generator.gnn_layers.{i}", f"generator/gnn_{i}"
        if gnn == "GCN":
            _map_gcn(m, t, o, n_convs=2)
        elif gnn == "GIN":
            _map_gin(m, t, o, n_convs=1)
        else:
            _map_gat(m, t, o, gat_heads)
    return m.out


def convert_pretrain_model(sd: Dict[str, np.ndarray], cfg: LxmertConfig,
                           visual_losses: Tuple[str, ...] = ("obj", "attr",
                                                             "feat")
                           ) -> Dict[str, np.ndarray]:
    """A reference LXRTPretraining state dict (`bert.*`, `cls.predictions.*`,
    `cls.seq_relationship.*`, `obj_predict_head.*`, `answer_head.*`) as the
    PretrainModel's flat JAX names. The masked-LM decoder is tied to the
    word-embedding table, so of `cls.predictions` only the transform and
    the bias convert; `cls.predictions.decoder.weight` is left unread."""
    sd = strip_prefixes(sd)
    _, m = convert_lxrt_bert(sd, cfg, torch_prefix="bert.",
                             our_prefix="lxrt")
    m.linear("cls.predictions.transform.dense", "lm_head/transform/dense")
    m.layernorm("cls.predictions.transform.LayerNorm",
                "lm_head/transform/LayerNorm")
    bias = m._take("cls.predictions.bias")
    if bias is not None:
        m.out["lm_head/bias"] = bias
    m.linear("cls.seq_relationship", "seq_relationship")
    m.linear("answer_head.logit_fc.0", "answer_head/fc1")
    m.layernorm("answer_head.logit_fc.2", "answer_head/ln")
    m.linear("answer_head.logit_fc.3", "answer_head/fc2")
    m.linear("obj_predict_head.transform.dense", "obj_head/transform/dense")
    m.layernorm("obj_predict_head.transform.LayerNorm",
                "obj_head/transform/LayerNorm")
    for key in visual_losses:
        m.linear(f"obj_predict_head.decoder_dict.{key}",
                 f"obj_head/decoder_{key}")
    return m.out


def merge_into(model: torch.nn.Module, flat: Dict[str, np.ndarray]
               ) -> List[str]:
    """Copy each flat JAX-named array into `model`'s parameter of that name
    (`port_name`, Dense kernels transposed), in place and on the model's
    device. Returns the model's entries left as they were: those `flat`
    lacks and those whose shape differs (the JAX package's `merge_into`
    keeps both). A name with no counterpart in `model` raises. A
    tensor-parallel Dense takes its rank's slice of the whole tensor."""
    expected = model.state_dict()
    filled = set()
    mismatched = []
    with torch.no_grad():
        for key, arr in flat.items():
            name = port_name(key)
            if name not in expected:
                raise KeyError(f"{key!r} has no counterpart {name!r} in "
                               f"{type(model).__name__}")
            src = torch.from_numpy(np.asarray(arr))
            if key.endswith("/kernel"):
                src = src.transpose(-1, -2)
            src = local_slice(model, name, src)
            dst = expected[name]
            filled.add(name)
            if tuple(src.shape) != tuple(dst.shape):
                mismatched.append(f"{name}: shape {tuple(src.shape)} vs "
                                  f"{tuple(dst.shape)}")
                continue
            dst.copy_(src)
    return [n for n in expected if n not in filled] + mismatched
