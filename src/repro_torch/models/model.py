"""The decoder LM: embeddings -> layer periods -> head.

Counterpart of ``repro/models/model.py``.  Parameters and caches are
stacked per pattern *period* (as the reference stacks them for its
``lax.scan``); the port walks the periods in a Python loop, taking
period r of every tensor (``t[r]``, a view) and of every stacked packed
projection (``QTensor.period(r)``).  ``cfg.remat`` is kept in the config
but means nothing here: this serving path does not checkpoint.
``input_kind == "embeddings"`` (musicgen's frame embeddings) bypasses
the token embedding.

``prefill`` fills the caches it is given and ``decode_step`` writes one
token per row into them, in place; both return them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core.conv import matmul_f32
from repro_torch.core.quantize import f32_scalar
from repro_torch.kernels.modes import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.qtensor import QTensor
from repro_torch.models.blocks import apply_norm, block_forward, init_block, norm_params
from repro_torch.models.common import ModelConfig, ShardLayout, softcap
from repro_torch.models.kvcache import init_caches
from repro_torch.parallel import sharding

__all__ = ["init_lm", "forward_hidden", "logits_from_hidden", "forward",
           "prefill", "decode_step", "init_caches", "take_period"]


def _stack(trees: List[Any]) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def take_period(tree: Any, r: int) -> Any:
    """Period ``r`` of a period-stacked tree: every tensor indexed at its
    leading dim, every stacked QTensor through ``QTensor.period``."""
    if isinstance(tree, dict):
        return {k: take_period(v, r) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [take_period(v, r) for v in tree]
    if isinstance(tree, QTensor):
        return tree.period(r)
    return tree[r]


def init_lm(generator: torch.Generator, cfg: ModelConfig, layout: ShardLayout,
            dtype=torch.float32, device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """Random LM parameters on ``device``, drawn from ``generator`` (which
    must live there); the reference's tree: "embed", "blocks" (one
    period-stacked tree per pattern entry), "final_norm" and, unless the
    embeddings are tied, "lm_head"."""
    dev = resolve_device(device)
    vp = layout.pad_vocab(cfg.vocab_size)
    d = cfg.d_model
    blocks = [_stack([init_block(generator, cfg, layout, mixer, ffn_kind, dtype, dev)
                      for _ in range(cfg.num_periods)])
              for mixer, ffn_kind in cfg.layer_pattern]
    params: Dict[str, Any] = {
        "embed": (torch.randn((vp, d), generator=generator, device=dev)
                  * d ** -0.5).to(dtype),
        "blocks": blocks,
        "final_norm": norm_params(cfg, d, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": (torch.randn((d, vp), generator=generator, device=dev)
                                   * d ** -0.5).to(dtype)}
    return params


def _embed(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    if cfg.input_kind == "embeddings":
        x = batch["embeddings"]
    else:
        x = params["embed"][batch["tokens"]]
    return x.to(cfg.dtype)


def _layers(params, x, cfg: ModelConfig, layout: ShardLayout, *, decode: bool,
            caches=None, step=None):
    """Every block over x, period by period; returns (x, aux)."""
    positions = None if decode else torch.arange(x.shape[1], dtype=torch.int32,
                                                  device=x.device)
    aux = 0.0
    for r in range(cfg.num_periods):
        for i, (mixer, ffn_kind) in enumerate(cfg.layer_pattern):
            cache = None if caches is None else take_period(caches[i], r)
            x, _, a = block_forward(take_period(params["blocks"][i], r), x, positions,
                                    cfg, layout, mixer, ffn_kind, cache=cache,
                                    step=step, decode=decode)
            aux = aux + a
    return x, aux


def forward_hidden(params, batch, cfg: ModelConfig, layout: ShardLayout
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (hidden (B,S,D) after the final norm, aux loss)."""
    x = sharding.constrain(_embed(params, batch, cfg), ("batch", "seq", "embed"))
    x, aux = _layers(params, x, cfg, layout, decode=False)
    x = apply_norm(params["final_norm"], x, cfg)
    return x, f32_scalar(aux, x)


def logits_from_hidden(params, x: torch.Tensor, cfg: ModelConfig,
                       layout: ShardLayout) -> torch.Tensor:
    """Head projection (+ final softcap): bf16 operands, float32 products
    and sums -> float32 (B, S, Vp)."""
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]["w"]
    lead = x.shape[:-1]
    logits = matmul_f32(x.reshape(-1, x.shape[-1]).to(torch.bfloat16),
                        w.to(torch.bfloat16)).reshape(*lead, w.shape[-1])
    logits = softcap(logits, cfg.final_logit_softcap)
    return sharding.constrain(logits, ("batch", "seq", "vocab"))


def forward(params, batch, cfg: ModelConfig, layout: ShardLayout):
    """Full forward -> (logits (B,S,Vp) float32, aux)."""
    x, aux = forward_hidden(params, batch, cfg, layout)
    return logits_from_hidden(params, x, cfg, layout), aux


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def prefill(params, batch, caches, cfg: ModelConfig, layout: ShardLayout):
    """Run the prompt, fill ``caches`` in place.  -> (last-position
    logits (B,1,Vp), caches)."""
    x = sharding.constrain(_embed(params, batch, cfg), ("batch", "seq", "embed"))
    x, _ = _layers(params, x, cfg, layout, decode=False, caches=caches)
    x = apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params, x[:, -1:], cfg, layout), caches


def decode_step(params, batch, caches, step, cfg: ModelConfig, layout: ShardLayout):
    """One token for every sequence.

    batch: {"tokens": (B,1)} or {"embeddings": (B,1,D)}; step: the
    current position (an int, a scalar or a per-row (B,) tensor).  ->
    (logits (B,1,Vp), caches, written in place)."""
    x = sharding.constrain(_embed(params, batch, cfg), ("batch", None, "embed"))
    if not isinstance(step, torch.Tensor):      # one fill, not one per layer
        step = torch.full((x.shape[0],), int(step), dtype=torch.int32, device=x.device)
    x, _ = _layers(params, x, cfg, layout, decode=True, caches=caches, step=step)
    x = apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params, x, cfg, layout), caches
