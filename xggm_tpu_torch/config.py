"""Configuration dataclasses read by the serving path.

Mirrors the fields of `xggm_tpu/config.py` that the encoder, the answer head
and the server read, with torch dtypes in place of `jnp` ones.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

# Fixed data-shape contract: 36 objects/image, 2048-d Faster-RCNN features,
# 4-d boxes, 20 text tokens.
NUM_OBJECTS = 36
VISUAL_FEAT_DIM = 2048
VISUAL_POS_DIM = 4
MAX_SEQ_LENGTH = 20


@dataclass(frozen=True)
class BertConfig:
    """BERT-base encoder hyperparameters."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
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


@dataclass(frozen=True)
class LxmertConfig:
    """Encoder config: BERT core + visual streams + compute dtype.

    Parameters stay float32; matmul inputs are cast to `compute_dtype`;
    LayerNorm and softmax run in float32. `stacked_layers`, `remat` and
    `pp_stages` exist so that a JAX config carries over field for field, but
    this port runs only the per-layer path and raises if any is set.
    """

    bert: BertConfig = field(default_factory=BertConfig)
    visual: VisualConfig = field(default_factory=VisualConfig)
    dtype: str = "float32"
    stacked_layers: bool = False
    remat: bool = False
    pp_stages: int = 0

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def replace(self, **kw) -> "LxmertConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class XGGMConfig:
    """Top-level bundle: encoder config + answer vocabulary size."""

    lxmert: LxmertConfig = field(default_factory=LxmertConfig)
    num_answers: int = 1842  # GQA-OOD trainval answer vocabulary size

    def replace(self, **kw) -> "XGGMConfig":
        return dataclasses.replace(self, **kw)


def gqa_ood_config(**overrides) -> XGGMConfig:
    """GQA-OOD recipe widths: 9/5/5 layers, hidden 768, 1842 answers."""
    cfg = XGGMConfig(
        lxmert=LxmertConfig(visual=VisualConfig(l_layers=9, x_layers=5,
                                                r_layers=5)))
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
        num_answers=16,
    )
    return cfg.replace(**overrides) if overrides else cfg
