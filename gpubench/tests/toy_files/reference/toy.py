"""The toy cell's plain reference: each rank's vectors, made from the seed,
and the sum of each pool entry's all-reduce over the ranks."""

from __future__ import annotations

from typing import List

import torch


def make_inputs(cfg, seed: int, rank: int, pool: int, device) -> torch.Tensor:
    """Rank ``rank``'s ``pool`` vectors: integers in [-8, 8) as float32."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + rank) % 2**63)
    return torch.randint(-8, 8, (pool, cfg["elements"]), generator=g,
                         device=device).to(torch.float32)


def sums(cfg, seed: int, world: int, pool: int, device) -> List[float]:
    """The float64 sum of each pool entry summed over ``world`` ranks."""
    total = [0.0] * pool
    for r in range(world):
        part = make_inputs(cfg, seed, r, pool, device).sum(dim=1, dtype=torch.float64)
        total = [a + b for a, b in zip(total, part.tolist())]
    return total
