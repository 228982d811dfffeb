"""What the plain references share: the seed streams of a run, and the
paper's binary and ternary quantizers (§II-B) on float values."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["sub_seed", "ternary", "binary"]


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for stream ``tag`` of the run seeded ``seed``."""
    return int(np.random.SeedSequence([int(seed) % 2**64, tag]).generate_state(
        1, np.uint64)[0]) >> 1


def ternary(v: torch.Tensor, dim=None):
    """TWN: (sign(v) where |v| > 0.7 mean|v|, else 0; the mean |v| above the
    threshold), per tensor or along ``dim``."""
    a = v.abs()
    mean = a.mean() if dim is None else a.mean(dim=dim, keepdim=True)
    mask = a > 0.7 * mean
    t = torch.sign(v) * mask
    if dim is None:
        return t, (a * mask).sum() / mask.sum().clamp(min=1)
    return t, (a * mask).sum(dim=dim, keepdim=True) / mask.sum(dim=dim, keepdim=True).clamp(min=1)


def binary(v: torch.Tensor, dim=None):
    """(sign(v), 0 counting as +1; mean |v|), per tensor or along ``dim``."""
    s = torch.where(v < 0, -1.0, 1.0).to(v.dtype)
    a = v.abs()
    return s, (a.mean() if dim is None else a.mean(dim=dim, keepdim=True))
