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
    mode, backend = policy.ffn_proj, policy.backend_for("ffn_proj")
    g = project(params["gate"], x, mode, backend)
    u = project(params["up"], x, mode, backend)
    h = (activation(g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    h = sharding.constrain(h, ("batch", None, "ffn"))
    return project(params["down"], h, mode, backend)
