"""Token sampling: greedy / temperature / top-k.

Counterpart of ``repro/serving/sampler.py``.  Greedy is ``argmax``
(ties to the first index, as ``jnp.argmax``); temperature and top-k
sampling draw from an explicit ``torch.Generator`` on the logits'
device, in place of ``jax.random.categorical``.  The two frameworks'
random streams differ, so only greedy decoding reproduces the
reference token for token.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["SamplerConfig", "sample"]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0      # 0 -> greedy
    top_k: int = 0                # 0 -> no truncation
    vocab_size: int = 0           # mask padded vocab columns if set


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           cfg: SamplerConfig) -> torch.Tensor:
    """logits (B, V) float32 -> token ids (B,) int64 on the logits'
    device; ``generator`` (on that device) is read only when sampling."""
    if cfg.vocab_size and cfg.vocab_size < logits.shape[-1]:
        logits = logits.clone()
        logits[..., cfg.vocab_size:] = -1e30
    if cfg.temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / cfg.temperature
    if cfg.top_k:
        kth = logits.topk(cfg.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
