"""The training step: fwd + bwd + (optional) microbatch accumulation +
(optional) error-feedback gradient compression + AdamW.

Counterpart of ``repro/train/train_step.py``, as a plain function (PyTorch
runs eagerly; nothing is jitted):

* the loss takes gradients through bf16 compute copies of the float32
  masters (``_cast_params_bf16``), the model's forward (remat per
  ``cfg.remat``) and the chunked loss, with ``torch.autograd.grad``;
* microbatches run in a loop; their gradients are summed from zeros in
  the reference's order, then divided by ``n_micro``;
* error-feedback int8 compression of the gradients (optim/compression.py);
* AdamW with float32 or int8 block-quantized moments, written into the
  state's tensors in place (optim/adamw.py).  The returned state has the
  reference's keys: ``params``, ``opt`` {``step``, ``m``, ``v``} and, with
  compression, ``ef``.

On one device the sharding constraints are the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.kernels.modes import DEFAULT_DEVICE, resolve_device
from repro_torch.models import model as model_mod
from repro_torch.models.common import ModelConfig, ShardLayout
from repro_torch.optim import adamw, compression
from repro_torch.train.loss import xent_loss
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["TrainStepConfig", "make_train_step", "init_train_state",
           "make_loss_fn", "value_and_grad"]


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    optimizer: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)
    microbatch: int = 1           # grad-accumulation factor
    ef_compression: bool = False  # int8 error-feedback DP gradient compression
    z_loss: float = 0.0
    seq_chunk: int = 1024         # loss head chunking
    cast_params_bf16: bool = True # mixed precision: bf16 compute params


def _cast_params_bf16(params):
    """f32 master -> bf16 compute copies, inside the autograd graph, so
    each gradient reaches its float32 master through the cast.  1-D
    params (norm scales/biases) stay f32 — they are tiny and
    precision-critical."""
    def leaf(x):
        if x.dtype == torch.float32 and x.ndim >= 2:
            return x.to(torch.bfloat16)
        return x
    return tree_map(leaf, params)


def make_loss_fn(cfg: ModelConfig, layout: ShardLayout, tcfg: TrainStepConfig):
    """loss_fn(params, batch) -> (loss + aux, metrics {"nll", "tokens", "aux"})."""
    def loss_fn(params, batch):
        if tcfg.cast_params_bf16:
            params = _cast_params_bf16(params)
        hidden, aux = model_mod.forward_hidden(params, batch, cfg, layout)
        loss, metrics = xent_loss(params, hidden, batch, cfg, layout,
                                  seq_chunk=tcfg.seq_chunk, z_loss=tcfg.z_loss)
        return loss + aux, {**metrics, "aux": aux}
    return loss_fn


def init_train_state(generator: torch.Generator, cfg: ModelConfig, layout: ShardLayout,
                     tcfg: TrainStepConfig, *, device=DEFAULT_DEVICE):
    """-> {"params", "opt", "ef"?} on ``device`` (ef error buffers only if
    enabled); the parameters drawn from ``generator``, which lives there."""
    params = model_mod.init_lm(generator, cfg, layout, device=resolve_device(device))
    state: Dict[str, Any] = {
        "params": params,
        "opt": adamw.adamw_init(params, tcfg.optimizer),
    }
    if tcfg.ef_compression:
        state["ef"] = compression.ef_state_init(params)
    return state


def value_and_grad(loss_fn, params, batch):
    """-> ((loss, metrics), grads): the port's ``jax.value_and_grad(loss_fn,
    has_aux=True)(params, batch)`` over a tree of tensors.  The loss sees
    detached views of ``params`` (no copy); ``grads`` is a tree like
    ``params``, each leaf of its parameter's dtype (zeros where unused)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, batch)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p) for g, p in zip(grads, flat))
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_map(lambda _p: next(it), leaves)


def _accumulate_grads(loss_fn, params, batch, n_micro: int):
    """Loop over microbatches -> (mean loss, summed grads / n, the last
    microbatch's metrics)."""
    if n_micro == 1:
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        return loss, grads, metrics

    def split(x, i):
        per = x.shape[0] // n_micro
        return x[i * per:(i + 1) * per]

    loss_sum = torch.zeros((), dtype=torch.float32, device=batch["labels"].device)
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    for i in range(n_micro):
        mb = {k: split(v, i) for k, v in batch.items()}
        (loss, metrics), g = value_and_grad(loss_fn, params, mb)
        grads = tree_map(torch.add, grads, g)
        loss_sum = loss_sum + loss
    grads = tree_map(lambda g: g / n_micro, grads)
    return loss_sum / n_micro, grads, metrics


def make_train_step(cfg: ModelConfig, layout: ShardLayout,
                    tcfg: TrainStepConfig):
    """Returns train_step(state, batch) -> (state, metrics {"loss", "nll",
    "tokens", "aux", "lr", "grad_norm"}).  ``batch`` holds tensors on the
    state's device; the state's tensors are updated in place."""
    loss_fn = make_loss_fn(cfg, layout, tcfg)

    def train_step(state, batch):
        params = state["params"]
        loss, grads, metrics = _accumulate_grads(
            loss_fn, params, batch, tcfg.microbatch)

        if tcfg.ef_compression:
            grads, new_ef = compression.ef_compress_update(grads, state["ef"])

        new_params, new_opt, opt_metrics = adamw.adamw_update(
            grads, state["opt"], params, tcfg.optimizer)
        new_state = {"params": new_params, "opt": new_opt}
        if tcfg.ef_compression:
            new_state["ef"] = new_ef
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step
