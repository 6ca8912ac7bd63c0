"""Score-matching noise and dense-graph helpers (counterpart of
`xggm_tpu/ops/noise.py`). Every draw takes an explicit `torch.Generator` on
the tensor's device. A function that draws can be handed its draw instead
(`normal`, `geometric`, `xy`), which lets the tests replay the JAX
package's draws into the same math."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def _strict_upper(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones(n, n, dtype=like.dtype, device=like.device).triu(1)


def add_edge_noise(generator: torch.Generator, adjs: torch.Tensor,
                   sigma: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric Gaussian edge noise and its score target: noise ~
    N(0, sigma^2) on the strict upper triangle, mirrored below; returns
    (adjs + noise, -noise / sigma^2)."""
    raw = torch.randn(adjs.shape, generator=generator, dtype=adjs.dtype,
                      device=adjs.device) * sigma
    upper = raw * _strict_upper(adjs.shape[-1], adjs)
    noise = upper + upper.transpose(-1, -2)
    return adjs + noise, -noise / (sigma ** 2)


def add_feature_noise(generator: torch.Generator, feats: torch.Tensor,
                      sigma: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian node-feature noise and its score target:
    (feats + noise, -noise / sigma^2)."""
    noise = torch.randn(feats.shape, generator=generator, dtype=feats.dtype,
                        device=feats.device) * sigma
    return feats + noise, -noise / (sigma ** 2)


def apply_known_noise(x: torch.Tensor, noise: torch.Tensor,
                      sigma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """A pre-drawn noise tensor with the score target the draws above would
    give for it: (x + noise, -noise / sigma^2), the target in float32. Lets
    tests replay the noise of another implementation."""
    return x + noise.to(x.dtype), -noise.float() / (sigma ** 2)


def add_gaussian_noise(generator: Optional[torch.Generator],
                       adjs: torch.Tensor, sigma: float,
                       is_half: bool = False,
                       node_flags: Optional[torch.Tensor] = None,
                       normal: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric Gaussian adjacency noise and its score target: `normal` (a
    standard normal of adjs' shape, drawn from `generator` when None) times
    sigma on the strict upper triangle, its absolute value with `is_half`,
    mirrored below; returns (adjs + noise, -noise / sigma^2), both masked
    to the real nodes when `node_flags` [B, N] is given."""
    if normal is None:
        normal = torch.randn(adjs.shape, generator=generator,
                             dtype=adjs.dtype, device=adjs.device)
    upper = normal.to(adjs.dtype) * sigma * _strict_upper(adjs.shape[-1],
                                                          adjs)
    if is_half:
        upper = upper.abs()
    noise = upper + upper.transpose(-1, -2)
    out, grad = adjs + noise, -noise / (sigma ** 2)
    if node_flags is not None:
        out, grad = mask_adjs(out, node_flags), mask_adjs(grad, node_flags)
    return out, grad


def get_corrupt_k(generator: Optional[torch.Generator], min_k: int = 0,
                  max_k: Optional[int] = None, p: float = 0.5,
                  geometric: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A corruption count: a geometric draw of success probability p
    (support 1, 2, ...; drawn from `generator` on its device when
    `geometric` is None) plus min_k - 1, capped at max_k; an int64
    0-d tensor."""
    if geometric is None:
        geometric = torch.empty((), device=generator.device).geometric_(
            p, generator=generator)
    k = geometric.long() + (min_k - 1)
    return k if max_k is None else k.clamp_max(max_k)


def draw_toggle_indices(generator: torch.Generator, adj: torch.Tensor,
                        count: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (x, y) positions `toggle_edges` flips: min(count, N) rows and
    as many columns, each uniform and with replacement."""
    count = min(count, adj.shape[-1])
    x = torch.randint(0, adj.shape[0], (count,), generator=generator,
                      device=adj.device)
    y = torch.randint(0, adj.shape[1], (count,), generator=generator,
                      device=adj.device)
    return x, y


def toggle_edges(generator: Optional[torch.Generator], adj: torch.Tensor,
                 count: int = 1,
                 xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """Flip the edges (x, y) of one [N, N] 0/1 adjacency and their mirrors
    (y, x) to 1 - adj[x, y]; (x, y) from `draw_toggle_indices` unless
    given. Returns a new tensor."""
    x, y = draw_toggle_indices(generator, adj, count) if xy is None else xy
    change = 1.0 - adj[x, y]
    out = adj.clone()
    out[x, y] = change
    out[y, x] = change
    return out


def gen_list_of_data(generator: Optional[torch.Generator], x: torch.Tensor,
                     adjs: torch.Tensor, node_flags: torch.Tensor,
                     sigma_list: Sequence[float],
                     normals: Optional[Sequence[torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                List[torch.Tensor]]:
    """One flagged noisy copy of the batch per sigma (`add_gaussian_noise`,
    the i-th drawing `normals[i]` when given): (x tiled, the noisy
    adjacencies concatenated on the batch, node_flags tiled, the list of
    per-sigma score targets)."""
    noisy, grads = [], []
    for i, sigma in enumerate(sigma_list):
        a, g = add_gaussian_noise(
            generator, adjs, float(sigma), node_flags=node_flags,
            normal=None if normals is None else normals[i])
        noisy.append(a)
        grads.append(g)
    reps = len(sigma_list)
    return (x.repeat(reps, 1, 1), torch.cat(noisy, dim=0),
            node_flags.repeat(reps, 1), grads)


def node_feature_to_matrix(x: torch.Tensor) -> torch.Tensor:
    """[B, N, F] -> [B, N, N, 2F]: entry (i, j) is [x_i, x_j]."""
    b, n, f = x.shape
    return torch.cat([x[:, :, None, :].expand(b, n, n, f),
                      x[:, None, :, :].expand(b, n, n, f)], dim=-1)


def mask_adjs(adjs: torch.Tensor, node_flags: torch.Tensor) -> torch.Tensor:
    """Zero the rows and columns of padded nodes; adjs [B, C..., N, N],
    flags [B, N]."""
    extra = adjs.dim() - node_flags.dim() - 1
    f = node_flags.reshape(node_flags.shape[0], *([1] * extra),
                           node_flags.shape[-1]).to(adjs.dtype)
    return adjs * f[..., None, :] * f[..., :, None]


def pad_adjs(adj: torch.Tensor, node_number: int) -> torch.Tensor:
    """Zero-pad a square adjacency to [node_number, node_number]."""
    n = adj.shape[-1]
    if n > node_number:
        raise ValueError(f"adjacency ({n}) larger than target ({node_number})")
    pad = node_number - n
    return F.pad(adj, (0, pad, 0, pad))


def add_self_loops(adjs: torch.Tensor) -> torch.Tensor:
    """Set the diagonal to 1."""
    eye = torch.eye(adjs.shape[-1], dtype=adjs.dtype, device=adjs.device)
    return adjs * (1.0 - eye) + eye


def remove_self_loops(adjs: torch.Tensor) -> torch.Tensor:
    """Zero the diagonal of batched square matrices."""
    n = adjs.shape[-1]
    return adjs * (1.0 - torch.eye(n, dtype=adjs.dtype, device=adjs.device))


def check_adjs_symmetry(adjs: torch.Tensor) -> torch.Tensor:
    """The largest |adjs - adjs^T|, a 0-d tensor (0 for a symmetric
    batch)."""
    return (adjs - adjs.transpose(-1, -2)).abs().max()
