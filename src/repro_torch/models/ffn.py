"""Gated FFN (SwiGLU) with quantized projections.

Counterpart of ``repro/models/ffn.py``."""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels.modes import DEFAULT_DEVICE, resolve_device
from repro_torch.models.attention import project
from repro_torch.parallel import sharding

__all__ = ["init_ffn", "ffn"]


def init_ffn(generator: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32,
             device=DEFAULT_DEVICE) -> Dict[str, Any]:
    dev = resolve_device(device)

    def w(shape, std):
        return {"w": (torch.randn(shape, generator=generator, device=dev) * std).to(dtype)}

    return {"gate": w((d_model, d_ff), d_model ** -0.5),
            "up": w((d_model, d_ff), d_model ** -0.5),
            "down": w((d_ff, d_model), d_ff ** -0.5)}


def ffn(params: Dict[str, Any], x: torch.Tensor, policy: QuantPolicy,
        activation=F.silu) -> torch.Tensor:
    """down(act(gate x) * up x).  On a tensor-parallel split of "ffn" x is
    this rank's sequence shard (under sequence parallelism), gathered
    here; gate and up run column-parallel on this rank's ffn slice and
    down row-parallel, its partial sums reduced back into the shard."""
    mode, backend = policy.ffn_proj, policy.backend_for("ffn_proj")
    dt, col, row = x.dtype, None, None
    if sharding.tp_split("ffn") is not None:
        # float32: the partial cotangents sum in float32 (sharding.tp_enter)
        x, col, row = sharding.tp_enter(x), "col", "row"
    g = project(params["gate"], x, mode, backend, col).to(dt)
    u = project(params["up"], x, mode, backend, col).to(dt)
    h = (activation(g.to(torch.float32)) * u.to(torch.float32)).to(dt)
    h = sharding.constrain(h, ("batch", None, "ffn"))
    return project(params["down"], h, mode, backend, row)
