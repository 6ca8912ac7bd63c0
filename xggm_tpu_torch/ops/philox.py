"""Philox4x32-10, the counter-based generator of the attention-dropout masks.

The TPU kernels draw their dropout bits from the TPU's own generator, which
a GPU does not have. The port's kernels (`csrc/attention_dropout.cu`) carry a
`__device__` Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy
as 1, 2, 3", SC 2011; the Random123 constants and round), and this module is
the same generator in torch integer ops. Both draw the mask of one attention
call from the same counters, so the CPU path, the plain version on the card
and the kernels agree bit for bit.

Counter layout. For the row r of the flattened [B * H, Lq, Lk] scores, the
query i and the key j:

    key     = ((seed + r) mod 2^32, 0)        the per-row seed
    counter = (r, i, j // 4, 0)
    bits    = philox(counter, key)[j % 4]

The element is kept when bits >= uint32(rate * 0xFFFFFFFF), the threshold of
the TPU kernel's `_dropout_keep`, and a kept element is scaled by
1 / (1 - rate) in float32.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # key bumps (golden ratio, sqrt(3) - 1)
ROUNDS = 10
Word = Union[int, torch.Tensor]


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product a * b, for a constant
    a and int64 b holding uint32 values; a is split in 16-bit halves so that
    no partial product leaves int64."""
    p_lo = b * (a & 0xFFFF)
    p_hi = b * (a >> 16)
    hi = ((p_lo >> 16) + p_hi) >> 16
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & MASK32
    return hi, lo


def philox4x32(c0: Word, c1: Word, c2: Word, c3: Word, k0: Word,
               k1: Word) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 of counter (c0, c1, c2, c3) under key (k0, k1): four
    int64 tensors holding uint32 words. Arguments broadcast; Python ints are
    taken mod 2^32."""
    c0, c1, c2, c3, k0, k1 = (
        torch.as_tensor(x, dtype=torch.int64) & MASK32
        for x in (c0, c1, c2, c3, k0, k1))
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + _W0) & MASK32
            k1 = (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    """uint32 bits at or above which an element is kept."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    return int(rate * 0xFFFFFFFF)


def keep_scale(rate: float) -> float:
    """The float32 value 1 / (1 - rate) that scales a kept element."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def dropout_bits(seed: int, rows: int, lq: int, lk: int,
                 device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """The uint32 draws (as int64) of rows [rows, lq, lk] under `seed`."""
    blocks = (lk + 3) // 4
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None, None]
    i = torch.arange(lq, dtype=torch.int64, device=device)[None, :, None]
    b = torch.arange(blocks, dtype=torch.int64, device=device)[None, None, :]
    words = philox4x32(r, i, b, 0, seed + r, 0)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    return bits.reshape(rows, lq, 4 * blocks)[..., :lk]


def dropout_keep(seed: int, rows: int, lq: int, lk: int, rate: float,
                 device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """float32 keep/scale mask [rows, lq, lk] with values 0 and
    1 / (1 - rate): the mask the kernels draw for `seed`."""
    keep = dropout_bits(seed, rows, lq, lk, device) >= keep_threshold(rate)
    return torch.where(keep, keep_scale(rate), 0.0).to(torch.float32)
