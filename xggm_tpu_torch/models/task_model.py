"""Task models (counterpart of `xggm_tpu/models/task_model.py`): the LXMERT
encoder, the answer head and the GGM parts.

`XGGMModel` always holds `lxrt` and `logit_fc`, the serving path's
submodules; an artifact exported by the JAX package holds only those. Given
a `GGMConfig` it is a training model and also holds the GGM submodules:
  - generator: the graph generator `ggm.gnn` names (GCN, GIN or GAT);
  - encoder_adj: Linear(hid -> 630) + sigmoid (pooled -> triu adjacency);
  - node_fc: Linear(hid -> hid) + GeLU + LN(1e-5);
  - fusion_fc: Linear(2 hid -> hid) + GeLU + LN(1e-5).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from xggm_tpu_torch.config import (
    GGMConfig, LxmertConfig, NUM_OBJECTS, NUM_TRIU_EDGES)
from xggm_tpu_torch.ggm.generators import make_generator
from xggm_tpu_torch.ggm.gnn import LinearGeluLn
from xggm_tpu_torch.models.lxmert import AnswerHead, LxmertModel
from xggm_tpu_torch.ops.basic import DropoutRng, TorchLinear
from xggm_tpu_torch.ops.noise import (
    add_edge_noise, add_feature_noise, apply_known_noise, remove_self_loops)
from xggm_tpu_torch.utils.device import resolve_device

# Row-major strict-upper-triangular index pairs of the 36 x 36 adjacency:
# the order torch's `adj[ones.triu(1) == 1] = vals` fills.
_TRIU = torch.triu_indices(NUM_OBJECTS, NUM_OBJECTS, offset=1)

# Linear -> GeLU -> LN(1e-5), the JAX package's NodeFC.
NodeFC = LinearGeluLn


def triu_to_adjacency(vals: torch.Tensor) -> torch.Tensor:
    """[B, 630] upper-triangular values -> symmetric [B, 36, 36] with zero
    diagonal."""
    adj = vals.new_zeros(vals.shape[0], NUM_OBJECTS, NUM_OBJECTS)
    adj[:, _TRIU[0], _TRIU[1]] = vals
    return adj + adj.transpose(-1, -2)


def adjacency_to_triu(adj: torch.Tensor) -> torch.Tensor:
    """[B, 36, 36] -> [B, 630] row-major strict-upper entries."""
    return adj[:, _TRIU[0], _TRIU[1]]


class XGGMModel(nn.Module):
    """Encoder + answer head, and with `ggm` the GGM submodules; parameters
    uninitialised on `device` until `ops.basic.init_weights` or a state dict
    fills them. Every forward takes an optional `DropoutRng`; without one it
    is deterministic."""

    def __init__(self, cfg: LxmertConfig, num_answers: int,
                 ggm: Optional[GGMConfig] = None, *, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        dt = cfg.compute_dtype
        hid = cfg.bert.hidden_size
        self.cfg = cfg
        self.ggm = ggm
        self.num_answers = num_answers
        self.lxrt = LxmertModel(cfg, device=dev)
        self.logit_fc = AnswerHead(hid, num_answers, dt, device=dev)
        if ggm is not None:
            self.generator = make_generator(ggm.gnn, hid, ggm.num_layers,
                                            ggm.dropout, dt, ggm.gat_heads,
                                            device=dev)
            self.encoder_adj = TorchLinear(hid, NUM_TRIU_EDGES, dt,
                                           device=dev)
            self.node_fc = NodeFC(hid, hid, dt, device=dev)
            self.fusion_fc = NodeFC(2 * hid, hid, dt, device=dev)

    def forward(self, input_ids, input_mask, token_type_ids, feats, boxes,
                rng: Optional[DropoutRng] = None):
        """Encoder pass: ((lang_seq, visn_seq), input_mask, pooled)."""
        feat_seq, pooled = self.lxrt(input_ids, input_mask, token_type_ids,
                                     feats, boxes, rng=rng)
        return feat_seq, input_mask, pooled

    def clean_forward(self, input_ids, input_mask, token_type_ids, feats,
                      boxes, rng: Optional[DropoutRng] = None
                      ) -> torch.Tensor:
        """Encoder -> answer logits [B, num_answers] in float32."""
        _, _, pooled = self(input_ids, input_mask, token_type_ids, feats,
                            boxes, rng)
        return self.logit_fc(pooled)

    def encode_adjacency(self, pooled: torch.Tensor) -> torch.Tensor:
        """pooled [B, hid] -> symmetric sigmoid adjacency [B, 36, 36] in
        float32."""
        return triu_to_adjacency(torch.sigmoid(self.encoder_adj(pooled).float()))

    def node_features_from_pooled(self, pooled: torch.Tensor) -> torch.Tensor:
        """pooled -> 36 replicated node features through node_fc."""
        return self.node_fc(pooled[:, None, :].expand(-1, NUM_OBJECTS, -1))

    def fuse(self, pooled: torch.Tensor,
             node_feats: torch.Tensor) -> torch.Tensor:
        """fusion_fc([pooled, tanh(mean over nodes)])."""
        summary = torch.tanh(node_feats.mean(dim=1))
        return self.fusion_fc(torch.cat([pooled, summary.to(pooled.dtype)],
                                        dim=-1))

    def relation_branch(self, input_ids, input_mask, token_type_ids, feats,
                        boxes, adj_true, noise_generator: torch.Generator,
                        rng: Optional[DropoutRng] = None,
                        noise_override: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ...]:
        """Relation-generation branch: (logits, adj_gen, grad_log_noise,
        adj_true_nodiag), all float32. The edge noise is drawn from
        `noise_generator`, or replayed from `noise_override`."""
        (_, visn), _, pooled = self(input_ids, input_mask, token_type_ids,
                                    feats, boxes, rng)
        adj_true_nd = remove_self_loops(adj_true.float())
        adj_noise = self.encode_adjacency(pooled)
        if noise_override is not None:
            adj_noise, grad_log_noise = apply_known_noise(
                adj_noise, noise_override, self.ggm.sigma)
        else:
            adj_noise, grad_log_noise = add_edge_noise(
                noise_generator, adj_noise, self.ggm.sigma)
        node_feats, adj_gen = self.generator(visn, adj_noise.to(visn.dtype),
                                             rng)
        logits = self.logit_fc(self.fuse(pooled, node_feats))
        return logits, adj_gen.float(), grad_log_noise, adj_true_nd

    def representation_branch(self, input_ids, input_mask, token_type_ids,
                              feats, boxes, adj_true,
                              noise_generator: torch.Generator,
                              rng: Optional[DropoutRng] = None,
                              noise_override: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, ...]:
        """Representation-generation branch: (logits, node_feats_gen,
        feat_grad, visn_feats), all float32. The feature noise is applied in
        float32, then the node features and the adjacency go to the compute
        dtype for the generator."""
        (_, visn), _, pooled = self(input_ids, input_mask, token_type_ids,
                                    feats, boxes, rng)
        adj_true_nd = remove_self_loops(adj_true.float())
        node_feats = self.node_features_from_pooled(pooled).float()
        if noise_override is not None:
            node_feats, feat_grad = apply_known_noise(
                node_feats, noise_override, self.ggm.sigma)
        else:
            node_feats, feat_grad = add_feature_noise(
                noise_generator, node_feats, self.ggm.sigma)
        node_feats, _ = self.generator(node_feats.to(visn.dtype),
                                       adj_true_nd.to(visn.dtype), rng)
        logits = self.logit_fc(self.fuse(pooled, node_feats))
        return logits, node_feats.float(), feat_grad, visn.float()


class PlainModel(nn.Module):
    """Encoder + answer head baseline: forward returns the logits."""

    def __init__(self, cfg: LxmertConfig, num_answers: int, *,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.num_answers = num_answers
        self.lxrt = LxmertModel(cfg, device=dev)
        self.logit_fc = AnswerHead(cfg.bert.hidden_size, num_answers,
                                   cfg.compute_dtype, device=dev)

    def forward(self, input_ids, input_mask, token_type_ids, feats,
                boxes, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        _, pooled = self.lxrt(input_ids, input_mask, token_type_ids, feats,
                              boxes, rng=rng)
        return self.logit_fc(pooled)
