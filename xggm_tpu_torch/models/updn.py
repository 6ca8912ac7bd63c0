"""Bottom-Up-Top-Down (UpDn) VQA building blocks (counterpart of
`xggm_tpu/models/updn.py`): weight-normed FCNet, concat and projected
attention, the classifier head, the Gaussian layer, word and question
embeddings (GRU or LSTM, one or more layers, uni- or bidirectional), cosine
similarity and the contrastive ranking loss.

The JAX package's tree is kept: a weight-normed linear is flax
`WeightNorm(Dense_k, feature_axes=None)`, a Dense `Dense_k` beside a module
`wn` that holds one scalar scale (`WeightNormScale`, the weight used is
scale * W / sqrt(sum W^2 + 1e-12), flax's epsilon); the recurrent cells
are flax's, gate by gate: GRU `ir`, `iz`, `in` (with bias), `hr`, `hz`
(without) and `hn` (with), h' = (1 - z) n + z h; LSTM `ii`, `if`, `ig`,
`io` (without bias) and `hi`, `hf`, `hg`, `ho` (with), gates i, f, g, o.
A layer's input projections run over the whole sequence at once, then the
recurrence steps in a Python loop from a zero state (flax `nn.RNN`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from xggm_tpu_torch.ops.basic import (
    Dense, DropoutRng, Embedding, lecun_dense, maybe_dropout)


class WeightNormScale(nn.Module):
    """The scalar scale of flax WeightNorm(feature_axes=None) over the Dense
    `dense_name` of the parent module."""

    def __init__(self, dense_name: str, *, device=None):
        super().__init__()
        self.dense_name = dense_name
        self.scale = nn.Parameter(torch.empty((), device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, dense: Dense, x: torch.Tensor) -> torch.Tensor:
        w = dense.weight
        w = w * torch.rsqrt(w.square().sum() + 1e-12) * self.scale
        return F.linear(x, w, dense.bias)


class FCNet(nn.Module):
    """Weight-normed Linear + ReLU stack over dims [in, hid..., out] (`Dense_i`
    and `fc_i`); ReLU after the last layer too, as the reference."""

    def __init__(self, dims: Sequence[int], *, device=None):
        super().__init__()
        self.n = len(dims) - 1
        for i in range(self.n):
            setattr(self, f"Dense_{i}", lecun_dense(dims[i], dims[i + 1],
                                                    device=device))
            setattr(self, f"fc_{i}", WeightNormScale(f"Dense_{i}",
                                                     device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = F.relu(getattr(self, f"fc_{i}")(getattr(self, f"Dense_{i}"),
                                                x))
        return x


class Attention(nn.Module):
    """Concat attention over objects: softmax over them of a weight-normed
    linear (`Dense_0`, `linear`) of FCNet([v, q]) (`nonlinear`)."""

    def __init__(self, v_dim: int, q_dim: int, num_hid: int, *, device=None):
        super().__init__()
        self.nonlinear = FCNet((v_dim + q_dim, num_hid), device=device)
        self.Dense_0 = lecun_dense(num_hid, 1, device=device)
        self.linear = WeightNormScale("Dense_0", device=device)

    def forward(self, v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        q_tiled = q[:, None, :].expand(q.shape[0], v.shape[1], q.shape[1])
        joint = self.nonlinear(torch.cat([v, q_tiled], 2))
        return torch.softmax(self.linear(self.Dense_0, joint), dim=1)


class NewAttention(nn.Module):
    """Projected product attention: FCNet(v) (`v_proj`) times FCNet(q)
    (`q_proj`), dropout, a weight-normed linear, softmax over objects."""

    def __init__(self, v_dim: int, q_dim: int, num_hid: int,
                 dropout: float = 0.2, *, device=None):
        super().__init__()
        self.p = dropout
        self.v_proj = FCNet((v_dim, num_hid), device=device)
        self.q_proj = FCNet((q_dim, num_hid), device=device)
        self.Dense_0 = lecun_dense(num_hid, 1, device=device)
        self.linear = WeightNormScale("Dense_0", device=device)

    def forward(self, v: torch.Tensor, q: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        joint = self.v_proj(v) * self.q_proj(q)[:, None, :]
        joint = maybe_dropout(joint, self.p, rng)
        return torch.softmax(self.linear(self.Dense_0, joint), dim=1)


class SimpleClassifier(nn.Module):
    """Linear, ReLU, dropout, Linear (`Dense_0`, `Dense_1`)."""

    def __init__(self, in_dim: int, hid_dim: int, out_dim: int,
                 dropout: float = 0.5, *, device=None):
        super().__init__()
        self.p = dropout
        self.Dense_0 = lecun_dense(in_dim, hid_dim, device=device)
        self.Dense_1 = lecun_dense(hid_dim, out_dim, device=device)

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        x = maybe_dropout(F.relu(self.Dense_0(x)), self.p, rng)
        return self.Dense_1(x)


class GaussianLayer(nn.Module):
    """Per-class diagonal-Gaussian log-likelihoods of x under `centers` and
    `covs` [n_classes, input_dim], L2-normalized over the classes."""

    def __init__(self, input_dim: int, n_classes: int, *, device=None):
        super().__init__()
        self.input_dim = input_dim
        self.centers = nn.Parameter(torch.empty(n_classes, input_dim,
                                                device=device))
        self.covs = nn.Parameter(torch.empty(n_classes, input_dim,
                                             device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.centers.normal_(0.0, 0.5, generator=generator)
            self.covs.exponential_(2.0, generator=generator).add_(0.2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        eps = torch.finfo(torch.float32).eps
        diff = x[:, None, :] - self.centers[None, :, :]
        z_log = (-0.5 * torch.log(self.covs).sum(-1)
                 - 0.5 * self.input_dim * math.log(2 * math.pi))
        exp_log = -0.5 * (diff * (1.0 / (self.covs + eps)) * diff).sum(-1)
        out = z_log[None, :] + exp_log
        return out / out.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class WordEmbedding(nn.Module):
    """Token embedding with an extra padding row at index ntoken (`emb`),
    then dropout."""

    def __init__(self, ntoken: int, emb_dim: int, dropout: float = 0.0, *,
                 device=None):
        super().__init__()
        self.p = dropout
        self.emb = Embedding(ntoken + 1, emb_dim,
                             stddev=1.0 / math.sqrt(emb_dim), device=device)

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        return maybe_dropout(self.emb(x), self.p, rng)


class _GRUCell(nn.Module):
    def __init__(self, n_in: int, n_hid: int, *, device=None):
        super().__init__()
        for g in ("r", "z", "n"):
            setattr(self, f"i{g}", lecun_dense(n_in, n_hid, device=device))
            setattr(self, f"h{g}", lecun_dense(n_hid, n_hid, bias=g == "n",
                                               device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, in] -> the hidden state of every step [B, T, hid]."""
        xr, xz, xn = (getattr(self, f"i{g}")(x) for g in ("r", "z", "n"))
        h = x.new_zeros(x.shape[0], xr.shape[-1])
        out = []
        for t in range(x.shape[1]):
            r = torch.sigmoid(xr[:, t] + self.hr(h))
            z = torch.sigmoid(xz[:, t] + self.hz(h))
            n = torch.tanh(xn[:, t] + r * self.hn(h))
            h = (1.0 - z) * n + z * h
            out.append(h)
        return torch.stack(out, 1)


class _LSTMCell(nn.Module):
    def __init__(self, n_in: int, n_hid: int, *, device=None):
        super().__init__()
        for g in ("i", "f", "g", "o"):
            setattr(self, f"i{g}", lecun_dense(n_in, n_hid, bias=False,
                                               device=device))
            setattr(self, f"h{g}", lecun_dense(n_hid, n_hid, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xi, xf, xg, xo = (getattr(self, f"i{g}")(x)
                          for g in ("i", "f", "g", "o"))
        h = c = x.new_zeros(x.shape[0], xi.shape[-1])
        out = []
        for t in range(x.shape[1]):
            i = torch.sigmoid(xi[:, t] + self.hi(h))
            f = torch.sigmoid(xf[:, t] + self.hf(h))
            g = torch.tanh(xg[:, t] + self.hg(h))
            o = torch.sigmoid(xo[:, t] + self.ho(h))
            c = f * c + i * g
            h = o * torch.tanh(c)
            out.append(h)
        return torch.stack(out, 1)


class QuestionEmbedding(nn.Module):
    """GRU or LSTM question encoder (`fwd_l`, and `bwd_l` when
    bidirectional) returning the last step's hidden state; bidirectional
    concatenates the reversed pass's last step, which is the reference's
    backward output at t = 0."""

    def __init__(self, in_dim: int, num_hid: int, nlayers: int = 1,
                 bidirect: bool = False, rnn_type: str = "GRU", *,
                 device=None):
        super().__init__()
        cell = _LSTMCell if rnn_type == "LSTM" else _GRUCell
        self.nlayers = nlayers
        self.bidirect = bidirect
        for d in ("fwd", "bwd") if bidirect else ("fwd",):
            for layer in range(nlayers):
                setattr(self, f"{d}_{layer}", cell(
                    in_dim if layer == 0 else num_hid, num_hid,
                    device=device))

    def _run(self, direction: str, x: torch.Tensor) -> torch.Tensor:
        for layer in range(self.nlayers):
            x = getattr(self, f"{direction}_{layer}")(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_f = self._run("fwd", x)[:, -1]
        if not self.bidirect:
            return out_f
        out_b = self._run("bwd", x.flip(1))[:, -1]
        return torch.cat([out_f, out_b], dim=1)

    def forward_all(self, x: torch.Tensor) -> torch.Tensor:
        """Every step's output of the forward layers [B, T, num_hid]."""
        return self._run("fwd", x)


def cosine_sim(images: torch.Tensor, captions: torch.Tensor) -> torch.Tensor:
    """Cosine similarity matrix of the rows of images and captions."""
    im = images / images.norm(dim=1, keepdim=True).clamp_min(1e-8)
    s = captions / captions.norm(dim=1, keepdim=True).clamp_min(1e-8)
    return im @ s.T


def contrastive_loss(images_embedded: torch.Tensor,
                     captions_embedded: torch.Tensor, margin: float = 0.2,
                     max_violation: bool = True) -> torch.Tensor:
    """Bidirectional hinge ranking loss over the cosine scores, the
    hardest negative of each row and column with `max_violation`, else
    their sum."""
    scores = cosine_sim(images_embedded, captions_embedded)
    diagonal = scores.diagonal()[:, None]
    eye = torch.eye(scores.shape[0], dtype=torch.bool, device=scores.device)
    cost_s = (margin + scores - diagonal).clamp_min(0.0).masked_fill(eye, 0.0)
    cost_im = (margin + scores - diagonal.T).clamp_min(0.0).masked_fill(
        eye, 0.0)
    if max_violation:
        return cost_s.max(1).values.sum() + cost_im.max(0).values.sum()
    return cost_s.sum() + cost_im.sum()
