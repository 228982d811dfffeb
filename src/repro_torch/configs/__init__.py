"""Model configurations of the port: the paper's CNN (``paper_cnn``) and
the LM registry — ``get_config("tinyllama-1.1b")`` etc.

Counterpart of ``repro/configs``: every architecture exposes its full
published ``CONFIG`` and a ``SMOKE`` (same family and features, tiny
dims).  All ten load; the six dense-attention ones ("A"/"AL" mixers,
"D" FFNs: tinyllama-1.1b, gemma2-27b, starcoder2-7b, minitron-4b,
chameleon-34b, musicgen-large) run in this slice, and building mixtral,
qwen2-moe, mamba2 or jamba raises ``NotImplementedError`` naming the
slice that brings MoE and the SSM.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (  # noqa: F401
    chameleon_34b, gemma2_27b, jamba_1_5_large_398b, mamba2_1_3b,
    minitron_4b, mixtral_8x22b, musicgen_large, qwen2_moe_a2_7b,
    starcoder2_7b, tinyllama_1_1b,
)
from repro_torch.configs.base import SHAPES, SUBQUADRATIC, ShapeSpec, applicable_shapes
from repro_torch.models.common import ModelConfig

__all__ = ["ARCHS", "get_config", "get_smoke", "list_archs", "SHAPES",
           "ShapeSpec", "applicable_shapes", "SUBQUADRATIC", "all_cells"]

_MODULES = (
    chameleon_34b, jamba_1_5_large_398b, musicgen_large, mixtral_8x22b,
    qwen2_moe_a2_7b, minitron_4b, tinyllama_1_1b, starcoder2_7b,
    gemma2_27b, mamba2_1_3b,
)

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
_SMOKES: Dict[str, ModelConfig] = {m.CONFIG.name: m.SMOKE for m in _MODULES}


def list_archs() -> List[str]:
    return list(ARCHS)


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list(ARCHS)}")
    cfg = ARCHS[name]
    return cfg.with_(**overrides) if overrides else cfg


def get_smoke(name: str, **overrides) -> ModelConfig:
    cfg = _SMOKES[name]
    return cfg.with_(**overrides) if overrides else cfg


def all_cells():
    """Every (arch, shape) cell, long_500k only where applicable."""
    return [(a, s) for a in ARCHS for s in applicable_shapes(a)]
