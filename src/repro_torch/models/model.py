"""The decoder LM: embeddings -> layer periods -> head.

Counterpart of ``repro/models/model.py``.  Parameters and caches are
stacked per pattern *period* (as the reference stacks them for its
``lax.scan``); the port walks the periods in a Python loop.
``input_kind == "embeddings"`` (musicgen's frame embeddings) bypasses
the token embedding.

One loop (``_layers``) serves the training forward, ``prefill`` and
``decode_step``.  It unbinds every stacked parameter once
(``torch.unbind``: n views, whose backward is one ``stack``) and every
stacked packed projection into its periods (``QTensor.period``).
Indexing ``t[r]`` per period would give each period's backward a zero
tensor the size of the whole stack.  Caches, written in place, are taken
per period (``take_period``: ``t[r]``, a view).  In ``forward_hidden``
with ``cfg.remat`` and autograd on, each period runs under
``torch.utils.checkpoint`` (non-reentrant), as the reference wraps its
scan body in ``jax.checkpoint``; with ``cfg.remat_block`` and a pattern
of more than one block, each block is checkpointed too.  The backward
then runs each period's forward a second time, with the same inputs and
so the same quantization.  Serving never checkpoints.

``prefill`` fills the caches it is given (KV slabs, pages, SSM states)
and ``decode_step`` writes one token per row into them, in place; both
return them.  Against paged caches ``decode_step`` also takes a (B, 2)
``step`` of (start, n): a chunk of up to S new tokens per row
(``attention.paged_attention_step``).  The MoE aux losses of all blocks
are summed.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.conv import matmul_f32
from repro_torch.core.quantize import f32_scalar
from repro_torch.kernels.modes import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.qtensor import QTensor
from repro_torch.models.blocks import apply_norm, block_forward, init_block, norm_params
from repro_torch.models.common import ModelConfig, ShardLayout, softcap
from repro_torch.models.kvcache import init_caches
from repro_torch.parallel import sharding
from repro_torch.tree import map_with_paths

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


def _unbind_periods(tree: Any, n: int) -> List[Any]:
    """The ``n`` periods of a period-stacked tree, each leaf unbound once."""
    if isinstance(tree, dict):
        per = {k: _unbind_periods(v, n) for k, v in tree.items()}
        return [{k: per[k][r] for k in tree} for r in range(n)]
    if isinstance(tree, (list, tuple)):
        per = [_unbind_periods(v, n) for v in tree]
        return [[p[r] for p in per] for r in range(n)]
    if isinstance(tree, QTensor):
        return [tree.period(r) for r in range(n)]
    return list(torch.unbind(tree, 0))


def init_lm(generator: torch.Generator, cfg: ModelConfig, layout: ShardLayout,
            dtype=torch.float32, device=DEFAULT_DEVICE,
            keep: Optional[Callable[[str, torch.Tensor, bool], torch.Tensor]] = None
            ) -> Dict[str, Any]:
    """Random LM parameters on ``device``, drawn from ``generator`` (which
    must live there); the reference's tree: "embed", "blocks" (one
    period-stacked tree per pattern entry), "final_norm" and, unless the
    embeddings are tied, "lm_head".

    ``keep(path, leaf, stacked)`` maps each leaf as it is drawn to what
    the tree holds: for a period-stacked leaf it gets one period's slice
    (``stacked`` True) and the stack is made of what it returns.  The
    training mesh keeps each rank's shard this way, one leaf at a time."""
    dev = resolve_device(device)
    vp = layout.pad_vocab(cfg.vocab_size)
    d = cfg.d_model

    def kept(tree, prefix, stacked=False):
        if keep is None:
            return tree
        if isinstance(tree, torch.Tensor):
            return keep(prefix, tree, stacked)
        return map_with_paths(lambda path, t: keep(path, t, stacked), tree, prefix)

    blocks = [_stack([kept(init_block(generator, cfg, layout, mixer, ffn_kind, dtype, dev),
                           f"blocks/{i}", stacked=True)
                      for _ in range(cfg.num_periods)])
              for i, (mixer, ffn_kind) in enumerate(cfg.layer_pattern)]
    params: Dict[str, Any] = {
        "embed": kept((torch.randn((vp, d), generator=generator, device=dev)
                       * d ** -0.5).to(dtype), "embed"),
        "blocks": blocks,
        "final_norm": kept(norm_params(cfg, d, dtype, dev), "final_norm"),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": kept((torch.randn((d, vp), generator=generator, device=dev)
                                        * d ** -0.5).to(dtype), "lm_head/w")}
    return params


def _embed(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    if cfg.input_kind == "embeddings":
        x = batch["embeddings"]
    else:
        x = params["embed"][batch["tokens"]]
    return x.to(cfg.dtype)


def _layers(params, x, cfg: ModelConfig, layout: ShardLayout, *, decode: bool,
            caches=None, step=None, remat: bool = False):
    """Every block over x, period by period; returns (x, aux).  Each
    stacked parameter is unbound once and each period's cache taken with
    ``take_period``; with ``remat`` each period, and with ``cfg.remat_block``
    and a longer pattern each block too, runs under ``checkpoint``."""
    positions = None if decode else torch.arange(x.shape[1], dtype=torch.int32,
                                                  device=x.device)
    remat_block = remat and cfg.remat_block and cfg.period > 1

    def period(pp, x, r):
        aux = 0.0
        for i, (mixer, ffn_kind) in enumerate(cfg.layer_pattern):
            def fwd(p, x, *, m=mixer, f=ffn_kind,
                    c=None if caches is None else take_period(caches[i], r)):
                return block_forward(p, x, positions, cfg, layout, m, f, cache=c,
                                     step=step, decode=decode)[::2]
            x, a = checkpoint(fwd, pp[i], x, use_reentrant=False) if remat_block \
                else fwd(pp[i], x)
            aux = aux + a
        return x, aux

    aux = 0.0
    for r, pp in enumerate(_unbind_periods(params["blocks"], cfg.num_periods)):
        x, a = checkpoint(period, pp, x, r, use_reentrant=False) if remat else period(pp, x, r)
        aux = aux + a
    return x, aux


def forward_hidden(params, batch, cfg: ModelConfig, layout: ShardLayout
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (hidden (B,S,D) after the final norm, aux loss).  The training
    forward: periods checkpointed under ``cfg.remat`` when autograd is on
    (module note)."""
    x = sharding.constrain(_embed(params, batch, cfg), ("batch", "seq", "embed"))
    x, aux = _layers(params, x, cfg, layout, decode=False,
                     remat=cfg.remat and torch.is_grad_enabled())
    x = apply_norm(params["final_norm"], x, cfg)
    return x, aux if isinstance(aux, torch.Tensor) else f32_scalar(aux, x)


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

    batch: {"tokens": (B,S)} or {"embeddings": (B,S,D)}, S = 1 but for a
    chunk against paged caches; step: the current position (an int, a
    scalar or a per-row (B,) tensor), or (B, 2) (start, n) rows for a
    paged chunk.  -> (logits (B,S,Vp), caches, written in place)."""
    x = sharding.constrain(_embed(params, batch, cfg), ("batch", None, "embed"))
    if not isinstance(step, torch.Tensor):      # one fill, not one per layer
        step = torch.full((x.shape[0],), int(step), dtype=torch.int32, device=x.device)
    x, _ = _layers(params, x, cfg, layout, decode=True, caches=caches, step=step)
    x = apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params, x, cfg, layout), caches
