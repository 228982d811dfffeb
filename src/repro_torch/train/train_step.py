"""The training step: fwd + bwd + (optional) microbatch accumulation +
(optional) error-feedback gradient compression + AdamW.

Counterpart of ``repro/train/train_step.py``, as a plain function (PyTorch
runs eagerly; nothing is jitted), and like it one step for one device and
the mesh, whose constraints do nothing off the mesh:

* the loss takes gradients through compute copies of the float32 masters
  (``_compute_copies``: bf16 under ``cast_params_bf16``), the model's
  forward (remat per ``cfg.remat``) and the chunked loss, with
  ``torch.autograd.grad``;
* microbatches run in a loop; their gradients are summed from zeros in
  the reference's order, then divided by ``n_micro``;
* error-feedback int8 compression of the gradients (optim/compression.py);
* AdamW with float32 or int8 block-quantized moments, written into the
  state's tensors in place (optim/adamw.py).  The returned state has the
  reference's keys: ``params``, ``opt`` {``step``, ``m``, ``v``} and, with
  compression, ``ef``.

On the training mesh (the step called inside ``sharding.use_mesh(mesh,
TRAIN_RULES)``, or another training ruleset, on every rank) the state
holds this rank's shard of every leaf (``param_spec`` by path; moments
and EF buffers as their parameter, ``sharding.train_state_shardings``)
and the batch this rank's rows, split over ``sharding.batch_axes``:

* each compute copy is the local shard cast to bf16 (2-D float32 leaves
  under ``cast_params_bf16``, as on one device), then gathered
  (``sharding.constrain_spec``): the wire carries bf16, and the backward
  sums the bf16 cotangent over the batch axes onto this rank's shard (the
  reference's ZeRO-3 reduce-scatter).  Leaves no axis shards are not
  gathered; their float32 gradients are all-reduced over the batch axes;
* reductions over the batch inside the forward are the global batch's
  (``sharding.split_batch``): the activation statistics of every
  quantized projection, the MoE load balance and the loss's token count,
  so each rank's loss is its share of the global loss;
* microbatches split the rank's rows (the trainer deals them so that
  microbatch ``i`` holds the global batch's ``i``-th chunk);
* EF compression takes each leaf's global absmax, AdamW the global norm
  and, for int8 moments, the blocks of the unsharded last dim.

So a mesh step equals the one-device step up to the order of float sums
(and, on the bf16 wire, one bf16 rounding of each rank's cotangent before
the sum), and every integer core is the one-device core.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.kernels.modes import DEFAULT_DEVICE, resolve_device
from repro_torch.models import model as model_mod
from repro_torch.models.common import ModelConfig, ShardLayout
from repro_torch.optim import adamw, compression
from repro_torch.parallel import sharding
from repro_torch.train.loss import xent_loss
from repro_torch.tree import flatten_with_paths, tree_leaves, tree_map

__all__ = ["TrainStepConfig", "make_train_step", "init_train_state",
           "state_shardings", "make_loss_fn", "value_and_grad"]


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    optimizer: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)
    microbatch: int = 1           # grad-accumulation factor
    ef_compression: bool = False  # int8 error-feedback DP gradient compression
    z_loss: float = 0.0
    seq_chunk: int = 1024         # loss head chunking
    cast_params_bf16: bool = True # mixed precision: bf16 compute params


def _compute_copies(params, p_sh, cast_bf16: bool):
    """The compute copies of the float32 masters, inside the autograd
    graph, so each gradient reaches its master through them: under
    ``cast_bf16`` every float32 leaf of two or more dims is cast to bf16
    (1-D params, norm scales and biases, stay f32: they are tiny and
    precision-critical).  On the training mesh (``p_sh``, the params'
    ``LeafSharding`` tree) each sharded leaf is then gathered whole
    (``sharding.constrain_spec``), so the wire carries the cast copy;
    leaves no axis shards pass as they are (:func:`_sum_replicated`)."""
    def leaf(x, sh=None):
        if cast_bf16 and x.dtype == torch.float32 and x.ndim >= 2:
            x = x.to(torch.bfloat16)
        return sharding.constrain_spec(x, sh.spec) if sh is not None and sh.sharded else x
    return tree_map(leaf, params) if p_sh is None else tree_map(leaf, params, p_sh)


def _sum_replicated(grads, p_sh):
    """The gradients of leaves no mesh axis shards summed over the batch
    axes of the active ``sharding.split_batch``: their copies are not
    gathered, so no reduce-scatter reached them.  The identity off the
    mesh (``p_sh`` None)."""
    if p_sh is None:
        return grads
    return tree_map(lambda g, sh: g if sh.sharded else sharding.sum_over_batch(g), grads, p_sh)


def make_loss_fn(cfg: ModelConfig, layout: ShardLayout, tcfg: TrainStepConfig, p_sh=None):
    """loss_fn(params, batch) -> (loss + aux, metrics {"nll", "tokens",
    "aux", "share"}); ``share`` is the loss without the aux, on a split
    batch this rank's rows' share of the global one.  ``p_sh``: the
    params' ``LeafSharding`` tree on the training mesh (the compute copies
    are then gathered, :func:`_compute_copies`)."""
    def loss_fn(params, batch):
        params = _compute_copies(params, p_sh, tcfg.cast_params_bf16)
        hidden, aux = model_mod.forward_hidden(params, batch, cfg, layout)
        loss, metrics = xent_loss(params, hidden, batch, cfg, layout,
                                  seq_chunk=tcfg.seq_chunk, z_loss=tcfg.z_loss)
        return loss + aux, {**metrics, "aux": aux, "share": loss}
    return loss_fn


def init_train_state(generator: torch.Generator, cfg: ModelConfig, layout: ShardLayout,
                     tcfg: TrainStepConfig, *, device=DEFAULT_DEVICE, shardings=None):
    """-> {"params", "opt", "ef"?} on ``device`` (ef error buffers only if
    enabled); the parameters drawn from ``generator``, which lives there.

    With ``shardings`` (:func:`state_shardings`, inside ``use_mesh``) the
    state holds this rank's shards: every parameter is drawn whole, in the
    one-device order, and only its shard kept, one leaf (one period of a
    stacked leaf) at a time; moments and EF buffers are zeros of the
    shards' shapes."""
    dev = resolve_device(device)
    if shardings is None:
        params = model_mod.init_lm(generator, cfg, layout, device=dev)
        state: Dict[str, Any] = {
            "params": params,
            "opt": adamw.adamw_init(params, tcfg.optimizer),
        }
        if tcfg.ef_compression:
            state["ef"] = compression.ef_state_init(params)
        return state
    mesh = sharding.active().mesh
    by_path = dict(flatten_with_paths(shardings["params"]))

    def keep(path, t, stacked):
        spec = by_path[path].spec
        if stacked:
            if spec[0] is not None:
                raise NotImplementedError(f"{path}: a spec that shards the period dim")
            spec = spec[1:]
        return sharding.shard_leaf(t, spec, mesh)

    def zeros(sh, dtype=torch.float32):
        if isinstance(sh, adamw.Q8):
            return adamw.Q8(zeros(sh.q, torch.int8), zeros(sh.scale))
        return torch.zeros(sh.local_shape(mesh), dtype=dtype, device=dev)

    state = {"params": model_mod.init_lm(generator, cfg, layout, device=dev, keep=keep),
             "opt": {"step": torch.zeros((), dtype=torch.int32, device=dev),
                     "m": tree_map(zeros, shardings["opt"]["m"]),
                     "v": tree_map(zeros, shardings["opt"]["v"])}}
    if tcfg.ef_compression:
        state["ef"] = tree_map(zeros, shardings["ef"])
    return state


def state_shardings(cfg: ModelConfig, layout: ShardLayout, tcfg: TrainStepConfig, ctx=None):
    """The train state's :class:`~repro_torch.parallel.sharding.LeafSharding`
    tree under the active (or given) mesh context, from the whole-shape
    state on the ``meta`` device (no memory, no draws)."""
    skeleton = init_train_state(None, cfg, layout, tcfg, device="meta")
    return sharding.train_state_shardings(skeleton, ctx or sharding.active())


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
    microbatch's metrics).  Each microbatch's loss is its ``share`` summed
    over the batch axes (one all-reduce for all of them and the last nll;
    the identity off the mesh) plus its aux, which is the global batch's
    already."""
    rows = batch["labels"].shape[0]
    if rows % n_micro:
        raise ValueError(f"{rows} rows do not split into {n_micro} microbatches")
    per = rows // n_micro
    shares, auxes, grads = [], [], None
    for i in range(n_micro):
        mb = batch if n_micro == 1 else {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        (_, metrics), g = value_and_grad(loss_fn, params, mb)
        if n_micro == 1:
            grads = g
        else:
            if grads is None:
                grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), params)
            grads = tree_map(torch.add, grads, g)
        shares.append(metrics.pop("share"))
        auxes.append(metrics["aux"])
    red = sharding.sum_over_batch(torch.stack(shares + [metrics["nll"]]))
    metrics["nll"] = red[n_micro]
    if n_micro == 1:
        return red[0] + auxes[0], grads, metrics
    loss = torch.zeros((), dtype=torch.float32, device=red.device)
    for i in range(n_micro):
        loss = loss + (red[i] + auxes[i])
    return loss / n_micro, tree_map(lambda g: g / n_micro, grads), metrics


def make_train_step(cfg: ModelConfig, layout: ShardLayout,
                    tcfg: TrainStepConfig):
    """Returns train_step(state, batch) -> (state, metrics {"loss", "nll",
    "tokens", "aux", "lr", "grad_norm"}).  ``batch`` holds tensors on the
    state's device; the state's tensors are updated in place.  Called
    inside ``sharding.use_mesh`` the step runs on the training mesh
    (module docstring): ``state`` then holds this rank's shards and
    ``batch`` this rank's rows."""
    cache: Dict[Any, Any] = {}

    def train_step(state, batch):
        ctx = sharding.active()
        shardings = mesh = None
        if ctx is not None:
            key = (id(ctx.mesh), id(ctx.rules))
            if key not in cache:
                cache.clear()
                cache[key] = state_shardings(cfg, layout, tcfg, ctx)
            shardings, mesh = cache[key], ctx.mesh
        p_sh = None if shardings is None else shardings["params"]
        loss_fn = make_loss_fn(cfg, layout, tcfg, p_sh)
        params = state["params"]
        with sharding.split_batch(mesh, sharding.batch_axes(ctx)):
            loss, grads, metrics = _accumulate_grads(loss_fn, params, batch, tcfg.microbatch)
            grads = _sum_replicated(grads, p_sh)

        if tcfg.ef_compression:
            grads, new_ef = compression.ef_compress_update(grads, state["ef"], mesh=mesh)

        new_params, new_opt, opt_metrics = adamw.adamw_update(
            grads, state["opt"], params, tcfg.optimizer, shardings=shardings, mesh=mesh)
        new_state = {"params": new_params, "opt": new_opt}
        if tcfg.ef_compression:
            new_state["ef"] = new_ef
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step
