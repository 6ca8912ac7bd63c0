"""Configuration dataclasses read by the serving and training paths.

Mirrors the fields of `xggm_tpu/config.py` that the encoder, the answer head,
the GGM modules, the optimizer and the server read, with torch dtypes in
place of `jnp` ones.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

# Fixed data-shape contract: 36 objects/image, 2048-d Faster-RCNN features,
# 4-d boxes, 20 text tokens.
NUM_OBJECTS = 36
VISUAL_FEAT_DIM = 2048
VISUAL_POS_DIM = 4
MAX_SEQ_LENGTH = 20
# C(36, 2) free upper-triangular adjacency entries (encoder_adj's width).
NUM_TRIU_EDGES = NUM_OBJECTS * (NUM_OBJECTS - 1) // 2


@dataclass(frozen=True)
class BertConfig:
    """BERT-base encoder hyperparameters."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class VisualConfig:
    """LXMERT layer counts and visual input widths."""

    l_layers: int = 9
    x_layers: int = 5
    r_layers: int = 5
    visual_feat_dim: int = VISUAL_FEAT_DIM
    visual_pos_dim: int = VISUAL_POS_DIM
    # pretraining's visual targets: object classes and attributes
    obj_id_num: int = 1600
    attr_id_num: int = 400


@dataclass(frozen=True)
class LxmertConfig:
    """Encoder config: BERT core + visual streams + compute dtype.

    Parameters stay float32; matmul inputs are cast to `compute_dtype`;
    LayerNorm and softmax run in float32. `remat` recomputes each encoder
    layer's activations in the backward (`torch.utils.checkpoint`).
    `stacked_layers` keeps each layer group's parameters as [L, ...] leaves
    (`lang_stack`, `r_stack`, `x_stack`; `models/lxmert.py::LayerStack`).
    `pp_stages` > 1 runs the lang -> visn -> x layer sequence as a GPipe
    pipeline over that many ranks of the mesh's pipe group, in
    `pp_microbatches` microbatches (`parallel/pipeline_lxmert.py`); it
    requires `stacked_layers` and a pipeline mesh (`set_pipeline_mesh`, which
    the trainers set).
    """

    bert: BertConfig = field(default_factory=BertConfig)
    visual: VisualConfig = field(default_factory=VisualConfig)
    dtype: str = "float32"
    stacked_layers: bool = False
    remat: bool = False
    pp_stages: int = 0
    # microbatches per pipelined batch; the bubble is (S - 1) / (M + S - 1)
    pp_microbatches: int = 4

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def replace(self, **kw) -> "LxmertConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class GGMConfig:
    """Graph-generative-module config."""

    gnn: str = "GCN"  # 'GCN' | 'GIN' | 'GAT'
    num_layers: int = 2
    sigma: float = 1.0  # score-matching noise scale
    delta: int = 5  # relation-branch probability delta / 10
    dropout: float = 0.5  # generator dropout
    gat_heads: int = 2  # GAT heads per round


@dataclass(frozen=True)
class TrainConfig:
    """Trainer, train-step and BertAdam hyperparameters."""

    batch_size: int = 32
    optim: str = "bert"
    lr: float = 1e-5
    epochs: int = 4
    dropout: float = 0.1
    seed: int = 9595
    warmup: float = 0.1
    downstream_lr_mult: float = 4.0  # all but lxrt train at 4x the base lr
    t_total_mult: float = 2.0  # t_total = 2 x the batches: two updates each
    weight_decay: float = 0.01
    grad_clip: float = 5.0
    # Loss multipliers: the GQA values; VQA-CP uses rel_d_mult 8.
    rel_d_mult: float = 12.0
    rel_sm_mult: float = 6.0
    rep_d_mult: float = 0.15
    rep_grad_mult: float = 6.0
    rep_sm_mult: float = 1.1
    # VQA-CP runs the clean phase before the GGM phase; GQA the reverse.
    clean_phase_first: bool = False
    # Pretraining: one BertAdam update on the mean gradient of this many
    # consecutive microbatches of batch_size (t_total counts the updates).
    accum_steps: int = 1
    # ZeRO-1: BertAdam's m and v split over the data group
    # (parallel/mesh.py::maybe_zero_shard_state); requires a mesh.
    shard_opt_state: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Data splits and where they live."""

    train: str = "train"
    valid: str = "val"
    test: Optional[str] = None
    tiny: bool = False  # keep the first 512 question records
    fast: bool = False  # accepted; task datasets do not subset on it
    num_workers: int = 2
    data_root: str = "data"
    vocab_path: Optional[str] = None  # default: {data_root}/vocab.txt
    prefetch_depth: int = 2  # batches the feeder holds ahead


@dataclass(frozen=True)
class MeshConfig:
    """The parallel layout: the batch split over the data group, and the
    size of the tensor-parallel model group (1: data parallelism only)."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel: int = 1

    def mesh_shape(self, n_devices: int) -> Tuple[int, int]:
        if n_devices % self.model_parallel:
            raise ValueError(f"{n_devices} devices not divisible by "
                             f"model_parallel={self.model_parallel}")
        return (n_devices // self.model_parallel, self.model_parallel)


@dataclass(frozen=True)
class XGGMConfig:
    """Top-level bundle: encoder, GGM, training, data and mesh configs,
    answer vocabulary size and the output directory."""

    lxmert: LxmertConfig = field(default_factory=LxmertConfig)
    ggm: GGMConfig = field(default_factory=GGMConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    num_answers: int = 1842  # GQA-OOD trainval answer vocabulary size
    output: str = "snap/debug"
    tmode: str = "OOD"  # 'OOD' | 'ID'

    def replace(self, **kw) -> "XGGMConfig":
        return dataclasses.replace(self, **kw)


def gqa_ood_config(**overrides) -> XGGMConfig:
    """GQA-OOD recipe: 9/5/5 layers, hidden 768, 1842 answers, GCN
    generator, batch 96, GGM phase first."""
    cfg = XGGMConfig(
        lxmert=LxmertConfig(visual=VisualConfig(l_layers=9, x_layers=5,
                                                r_layers=5)),
        ggm=GGMConfig(gnn="GCN", num_layers=2, sigma=1.0, delta=5),
        train=TrainConfig(batch_size=96, lr=5e-6, epochs=4,
                          clean_phase_first=False, rel_d_mult=12.0),
    )
    return cfg.replace(**overrides) if overrides else cfg


def vqacpv2_config(**overrides) -> XGGMConfig:
    """VQA-CP v2 recipe: delta 0 (the relation branch never fires), clean
    phase first, batch 92, 16039 answers."""
    cfg = XGGMConfig(
        lxmert=LxmertConfig(visual=VisualConfig(l_layers=9, x_layers=5,
                                                r_layers=5)),
        ggm=GGMConfig(gnn="GCN", num_layers=2, sigma=1.0, delta=0),
        train=TrainConfig(batch_size=92, lr=1e-6, epochs=4,
                          clean_phase_first=True, rel_d_mult=8.0),
        num_answers=16039,
    )
    return cfg.replace(**overrides) if overrides else cfg


def tiny_test_config(**overrides) -> XGGMConfig:
    """Small config for unit tests: 2/1/1 layers, small dims."""
    cfg = XGGMConfig(
        lxmert=LxmertConfig(
            bert=BertConfig(vocab_size=128, hidden_size=64,
                            num_attention_heads=4, intermediate_size=128,
                            max_position_embeddings=64),
            visual=VisualConfig(l_layers=2, x_layers=1, r_layers=1,
                                visual_feat_dim=32, visual_pos_dim=4),
        ),
        ggm=GGMConfig(gnn="GCN", num_layers=2, sigma=1.0, delta=5),
        train=TrainConfig(batch_size=4, lr=1e-4, epochs=1),
        num_answers=16,
    )
    return cfg.replace(**overrides) if overrides else cfg
