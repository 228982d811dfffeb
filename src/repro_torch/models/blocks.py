"""Residual blocks: (mixer, ffn) pairs per the config's layer pattern.

Counterpart of ``repro/models/blocks.py``: mixers "A" (global
attention), "AL" (sliding window) and "M" (the Mamba2/SSD mixer), ffns
"D" (gated dense), "E" (MoE, with its aux loss) and "-" (none).  An
attention mixer handed a paged cache entry runs
``paged_attention_step`` (a prefill is one write-then-attend chunk from
``positions[0]``); an "M" mixer handed a cache writes its decode state
into it, in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels.modes import DEFAULT_DEVICE, resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (attention, decode_attention, init_attention,
                                          paged_attention_step)
from repro_torch.models.common import ModelConfig, ShardLayout, layer_norm, rms_norm
from repro_torch.models.ffn import ffn, init_ffn
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.models.paged_kvcache import is_paged
from repro_torch.parallel import sharding

__all__ = ["init_block", "block_forward", "norm_params", "apply_norm"]


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
    p: Dict[str, Any] = {"pre_mixer_norm": norm_params(cfg, cfg.d_model, dtype, device)}
    if mixer in ("A", "AL"):
        p["mixer"] = init_attention(generator, cfg, layout, dtype, device)
    elif mixer == "M":
        p["mixer"] = ssm_mod.init_ssm(generator, cfg, dtype, device)
    else:
        raise ValueError(mixer)
    if cfg.post_block_norm:
        p["post_mixer_norm"] = norm_params(cfg, cfg.d_model, dtype, device)
    if ffn_kind == "D":
        p["pre_ffn_norm"] = norm_params(cfg, cfg.d_model, dtype, device)
        p["ffn"] = init_ffn(generator, cfg.d_model, cfg.d_ff, dtype, device)
    elif ffn_kind == "E":
        p["pre_ffn_norm"] = norm_params(cfg, cfg.d_model, dtype, device)
        p["ffn"] = init_moe(generator, cfg, dtype, device)
    elif ffn_kind != "-":
        raise ValueError(ffn_kind)
    if ffn_kind != "-" and cfg.post_block_norm:
        p["post_ffn_norm"] = norm_params(cfg, cfg.d_model, dtype, device)
    return p


def _write_state(cache: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor]):
    """Copy an SSM decode state into its cache entry, in place."""
    for key, val in state.items():
        cache[key].copy_(val)
    return cache


def block_forward(p: Dict[str, Any], x: torch.Tensor,
                  positions: Optional[torch.Tensor], cfg: ModelConfig,
                  layout: ShardLayout, mixer: str, ffn_kind: str, *,
                  cache=None, step=None, decode: bool = False,
                  ) -> Tuple[torch.Tensor, Any, Any]:
    """Returns (x, the cache written or None, aux loss: 0.0 but for an
    "E" ffn, whose aux loss is a float32 scalar)."""
    h = apply_norm(p["pre_mixer_norm"], x, cfg)
    new_cache = None
    if mixer in ("A", "AL"):
        window = cfg.sliding_window if mixer == "AL" else 0
        if cache is not None and is_paged(cache):
            st = step
            if not decode:
                # a prefill against a paged entry: the whole prompt is one
                # write-then-attend chunk from positions[0]
                b, s = h.shape[0], h.shape[1]
                st = torch.stack([positions[0].expand(b).to(torch.int32),
                                  torch.full((b,), s, dtype=torch.int32, device=h.device)],
                                 dim=1)
            h, new_cache = paged_attention_step(p["mixer"], h, cfg, layout, cache, st,
                                                window=window)
        elif decode:
            h, new_cache = decode_attention(p["mixer"], h, cfg, layout, cache, step,
                                            window=window)
        else:
            h, new_cache = attention(p["mixer"], h, positions, cfg, layout,
                                     window=window, cache_update=cache)
    elif decode:
        h, state = ssm_mod.ssm_decode(p["mixer"], h, cfg, cfg.policy, cache)
        new_cache = _write_state(cache, state)
    elif cache is not None:       # prefill: keep the state after the prompt
        h, state = ssm_mod.ssm_forward(p["mixer"], h, cfg, cfg.policy, return_state=True)
        new_cache = _write_state(cache, state)
    else:
        h = ssm_mod.ssm_forward(p["mixer"], h, cfg, cfg.policy)
    if cfg.post_block_norm:
        h = apply_norm(p["post_mixer_norm"], h, cfg)
    x = x + h

    aux = 0.0
    if ffn_kind != "-":
        h = apply_norm(p["pre_ffn_norm"], x, cfg)
        if ffn_kind == "E":
            h, aux = moe_ffn(p["ffn"], h, cfg, cfg.policy)
        else:
            h = ffn(p["ffn"], h, cfg.policy)
        if cfg.post_block_norm:
            h = apply_norm(p["post_ffn_norm"], h, cfg)
        x = x + h

    x = sharding.constrain(x, ("batch", "seq", "embed"))
    return x, new_cache, aux
