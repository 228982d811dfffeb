"""Residual blocks: (mixer, ffn) pairs per the config's layer pattern.

Counterpart of ``repro/models/blocks.py`` for the dense-attention
decoders: mixers "A" (global) and "AL" (sliding window), ffn "D" (gated
dense) and "-" (none).  The Mamba2 mixer "M" and the MoE ffn "E" wait for
their slice (ROADMAP.md queue 1) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels.modes import DEFAULT_DEVICE, resolve_device
from repro_torch.models.attention import attention, decode_attention, init_attention
from repro_torch.models.common import ModelConfig, ShardLayout, layer_norm, rms_norm
from repro_torch.models.ffn import ffn, init_ffn
from repro_torch.parallel import sharding

__all__ = ["init_block", "block_forward", "norm_params", "apply_norm"]

_LATER = {"M": "the Mamba2/SSD mixer 'M'", "E": "the MoE ffn 'E'"}


def _not_ported(kind: str):
    return NotImplementedError(
        f"{_LATER[kind]} is not ported yet (ROADMAP.md queue 1: MoE, SSM and "
        f"the paged cache)")


def norm_params(cfg: ModelConfig, dim: int, dtype=torch.float32,
                device=DEFAULT_DEVICE) -> Dict[str, Any]:
    dev = resolve_device(device)
    p = {"scale": torch.ones((dim,), dtype=dtype, device=dev)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=dev)
    return p


def apply_norm(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def init_block(generator: torch.Generator, cfg: ModelConfig, layout: ShardLayout,
               mixer: str, ffn_kind: str, dtype=torch.float32,
               device=DEFAULT_DEVICE) -> Dict[str, Any]:
    if mixer in _LATER or ffn_kind in _LATER:
        raise _not_ported(mixer if mixer in _LATER else ffn_kind)
    if mixer not in ("A", "AL"):
        raise ValueError(mixer)
    if ffn_kind not in ("D", "-"):
        raise ValueError(ffn_kind)
    p: Dict[str, Any] = {"pre_mixer_norm": norm_params(cfg, cfg.d_model, dtype, device),
                         "mixer": init_attention(generator, cfg, layout, dtype, device)}
    if cfg.post_block_norm:
        p["post_mixer_norm"] = norm_params(cfg, cfg.d_model, dtype, device)
    if ffn_kind == "D":
        p["pre_ffn_norm"] = norm_params(cfg, cfg.d_model, dtype, device)
        p["ffn"] = init_ffn(generator, cfg.d_model, cfg.d_ff, dtype, device)
        if cfg.post_block_norm:
            p["post_ffn_norm"] = norm_params(cfg, cfg.d_model, dtype, device)
    return p


def block_forward(p: Dict[str, Any], x: torch.Tensor,
                  positions: Optional[torch.Tensor], cfg: ModelConfig,
                  layout: ShardLayout, mixer: str, ffn_kind: str, *,
                  cache=None, step=None, decode: bool = False,
                  ) -> Tuple[torch.Tensor, Any, float]:
    """Returns (x, the cache written or None, aux loss: 0.0 without MoE)."""
    if mixer in _LATER or ffn_kind in _LATER:
        raise _not_ported(mixer if mixer in _LATER else ffn_kind)
    h = apply_norm(p["pre_mixer_norm"], x, cfg)
    window = cfg.sliding_window if mixer == "AL" else 0
    if decode:
        h, new_cache = decode_attention(p["mixer"], h, cfg, layout, cache, step,
                                        window=window)
    else:
        h, new_cache = attention(p["mixer"], h, positions, cfg, layout,
                                 window=window, cache_update=cache)
    if cfg.post_block_norm:
        h = apply_norm(p["post_mixer_norm"], h, cfg)
    x = x + h

    if ffn_kind != "-":
        h = apply_norm(p["pre_ffn_norm"], x, cfg)
        h = ffn(p["ffn"], h, cfg.policy)
        if cfg.post_block_norm:
            h = apply_norm(p["post_ffn_norm"], h, cfg)
        x = x + h

    x = sharding.constrain(x, ("batch", "seq", "embed"))
    return x, new_cache, 0.0
