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
  state's tensors in place (optim/adamw.py), as are the EF buffers.  The
  returned state has the reference's keys: ``params``, ``opt``
  {``step``, ``m``, ``v``} and, with compression, ``ef``.

On the training mesh (the step called inside ``sharding.use_mesh(mesh,
TRAIN_RULES)``, or another training ruleset, on every rank) the state
holds this rank's shard of every leaf (``param_spec`` by path; moments
and EF buffers as their parameter, ``sharding.train_state_shardings``)
and the batch this rank's rows, split over ``sharding.batch_axes``:

* each compute copy is the local shard cast to bf16 (2-D float32 leaves
  under ``cast_params_bf16``, as on one device), then gathered
  (``sharding.constrain_spec``) over the axes of its
  ``sharding.LeafPlan``: the wire carries bf16, and the backward sums the
  bf16 cotangent over the plan's axes onto this rank's shard (the
  reference's ZeRO-3 reduce-scatter).  Leaves no axis is gathered over
  pass as they are; their float32 gradients are all-reduced over those
  axes (:func:`_sum_replicated`);
* tensor and sequence parallelism (``sharding.leaf_plans``): a leaf
  keeps its chunk on the tensor-parallel axis ("model" under
  ``TRAIN_RULES`` and ``TRAIN_RULES_HYBRID``) along its "heads", "ffn",
  "vocab" and "ssm_heads" dims and is gathered over the rest (its "fsdp"
  axes), and the model computes on those chunks: column-parallel
  wq/wk/wv/gate/up (the experts' and the shared expert's too) and the
  rank's heads' columns of the Mamba2 ``in_proj``, row-parallel wo/down
  and ``out_proj``, the vocab-parallel embedding, head and loss.  Under
  ``TRAIN_RULES`` ("seq" on "model") the residual stream between blocks
  holds this rank's sequence shard, and the leaves whole on every rank of
  the axis (norm scales, the router) sum their gradients over it as well.
  ``ShardLayout.tp`` must give heads the axis divides
  (``models.common.train_layout``), and the SSM heads and every FFN width
  of an MoE layer must divide it (:func:`_check_tp_layout`).
  ``TRAIN_RULES_FSDP`` (whose "model" axis splits the batch) gathers every
  leaf whole (``sharding.whole_plans``);
* reductions over the batch inside the forward are the global batch's
  (``sharding.split_batch``): the activation statistics of every
  quantized projection (a row-parallel one's over the tensor-parallel
  axis too), the MoE load balance and the loss's token count, so each
  rank's loss is its share of the global loss;
* microbatches split the rank's rows (the trainer deals them so that
  microbatch ``i`` holds the global batch's ``i``-th chunk);
* EF compression takes each leaf's global absmax, AdamW the global norm
  (each element counted once, ``sharding.holds_first_copy``) and, for
  int8 moments, the blocks of the unsharded last dim.

So a mesh step equals the one-device step up to the order of float sums
(and, on the bf16 wire, one bf16 rounding of each rank's cotangent before
the sum), and every integer core is the one-device core: a row-parallel
projection's int32 partial counts sum to it exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch import obs
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


def _compute_copies(params, plans, cast_bf16: bool):
    """The compute copies of the float32 masters, inside the autograd
    graph, so each gradient reaches its master through them: under
    ``cast_bf16`` every float32 leaf of two or more dims is cast to bf16
    (1-D params, norm scales and biases, stay f32: they are tiny and
    precision-critical).  On the training mesh (``plans``, the params'
    ``sharding.LeafPlan`` tree) each leaf is then gathered over its plan's
    axes (``sharding.constrain_spec``), so the wire carries the cast copy;
    leaves gathered over none pass as they are (:func:`_sum_replicated`)."""
    def leaf(x, plan=None):
        if cast_bf16 and x.dtype == torch.float32 and x.ndim >= 2:
            x = x.to(torch.bfloat16)
        if plan is None or not plan.gathered:
            return x
        return sharding.constrain_spec(x, plan.gather, plan.sum_axes)
    return tree_map(leaf, params) if plans is None else tree_map(leaf, params, plans)


def _sum_replicated(grads, plans):
    """The gradients of leaves gathered over no axis summed over their
    plan's axes (the batch axes, and the tensor-parallel axis for a leaf
    each rank of it computes with a part of): no reduce-scatter reached
    them.  The identity off the mesh (``plans`` None)."""
    if plans is None:
        return grads
    split = sharding.batch_split()

    def leaf(g, plan):
        axes = [a for a in plan.sum_axes if split.mesh.axis_size(a) > 1]
        if plan.gathered or not axes:
            return g
        return split.mesh.all_reduce_axes_(g.contiguous(), axes, "sum")
    return tree_map(leaf, grads, plans)


def make_loss_fn(cfg: ModelConfig, layout: ShardLayout, tcfg: TrainStepConfig, plans=None):
    """loss_fn(params, batch) -> (loss + aux, metrics {"nll", "tokens",
    "aux", "share"}); ``share`` is the loss without the aux, on a split
    batch this rank's rows' share of the global one.  ``plans``: the
    params' ``sharding.LeafPlan`` tree on the training mesh (the compute
    copies are then gathered, :func:`_compute_copies`)."""
    def loss_fn(params, batch):
        params = _compute_copies(params, plans, tcfg.cast_params_bf16)
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
        with obs.annotate("repro_torch.train.forward"):
            loss, metrics = loss_fn(leaves, batch)
        flat = tree_leaves(leaves)
        with obs.annotate("repro_torch.train.backward"):
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


def _check_tp_layout(cfg: ModelConfig, layout: ShardLayout, tp: int, split, sp: bool):
    """Raise unless the parameters of ``layout`` split over ``tp`` ranks
    as the tensor-parallel forward needs: whole kv slots with their q
    groups on each rank, and q/k norms only under sequence parallelism
    (their gradient sums over the axis with the norms'); the Mamba2 heads
    split (their groups split too, or each rank's heads lie in one
    group); every FFN width of an MoE layer split.  Under sequence
    parallelism an MoE or SSM layer that kept its leaves whole would run
    on a sequence shard, whose capacity drops and scan are not the whole
    sequence's."""
    from repro_torch.models.attention import head_layout

    mixers = {m for m, _ in cfg.layer_pattern}
    if "heads" in split and mixers & {"A", "AL"}:
        hl = head_layout(cfg.num_heads, cfg.num_kv_heads, layout.tp)
        if hl.kvp % tp:
            raise ValueError(f"{cfg.name}: {hl.kvp} kv slots do not split over {tp} "
                             f"tensor-parallel ranks; build the state with "
                             f"ShardLayout(tp={tp}) (models.common.train_layout)")
        if cfg.qk_norm and not sp:
            raise NotImplementedError(f"{cfg.name}: q/k norms on heads split without "
                                      f"sequence parallelism")
    if "M" in mixers:
        h, g = cfg.ssm_nheads, cfg.ssm_ngroups
        if "ssm_heads" not in split or h % tp or (g % tp and tp % g):
            raise ValueError(f"{cfg.name}: {h} SSM heads in {g} groups do not split over "
                             f"{tp} tensor-parallel ranks (the heads and the groups must "
                             f"divide the axis, or the axis the groups)")
    if any(f == "E" for _, f in cfg.layer_pattern):
        widths = (cfg.d_ff, cfg.shared_expert_d_ff or tp)
        if "ffn" not in split or any(w % tp for w in widths):
            raise ValueError(f"{cfg.name}: the expert FFN (d_ff {cfg.d_ff}, shared "
                             f"{cfg.shared_expert_d_ff}) does not split over {tp} "
                             f"tensor-parallel ranks")


def make_train_step(cfg: ModelConfig, layout: ShardLayout,
                    tcfg: TrainStepConfig):
    """Returns train_step(state, batch) -> (state, metrics {"loss", "nll",
    "tokens", "aux", "lr", "grad_norm"}), with ``train_step.prepare(ctx,
    seq)`` to build its mesh plans ahead of the first call.  ``batch``
    holds tensors on the state's device; the state's tensors are updated
    in place.  Called inside ``sharding.use_mesh`` the step runs on the
    training mesh (module docstring): ``state`` then holds this rank's
    shards and ``batch`` this rank's rows."""
    cache: Dict[Any, Any] = {}

    def mesh_plan(ctx, seq: int):
        """(state shardings, leaf plans, split kwargs) for the active mesh
        and sequence length, cached per mesh and rules."""
        key = (id(ctx.mesh), id(ctx.rules), seq)
        if key not in cache:
            cache.clear()
            shardings = state_shardings(cfg, layout, tcfg, ctx)
            tp = sharding.tp_axis(ctx)
            if tp is None:
                cache[key] = (shardings, sharding.whole_plans(shardings["params"], ctx), {})
            else:
                size = ctx.axis_sizes[tp]
                sp = sharding.seq_parallel(ctx, tp) and seq % size == 0
                plans, split = sharding.leaf_plans(shardings["params"], ctx, sp=sp)
                cache[key] = (shardings, plans, {"tp": tp, "split": split, "sp": sp,
                                                 "seq": seq})
        return cache[key]

    def train_step(state, batch):
        with obs.annotate("repro_torch.train.step"):
            return _step(state, batch)

    def _step(state, batch):
        ctx = sharding.active()
        shardings = mesh = plans = None
        kw: Dict[str, Any] = {}
        if ctx is not None:
            shardings, plans, kw = mesh_plan(ctx, int(batch["labels"].shape[1]))
            mesh = ctx.mesh
            if kw:
                _check_tp_layout(cfg, layout, ctx.axis_sizes[kw["tp"]], kw["split"], kw["sp"])
        loss_fn = make_loss_fn(cfg, layout, tcfg, plans)
        params = state["params"]
        with sharding.split_batch(mesh, sharding.batch_axes(ctx), **kw):
            loss, grads, metrics = _accumulate_grads(loss_fn, params, batch, tcfg.microbatch)
            grads = _sum_replicated(grads, plans)

        if tcfg.ef_compression:
            grads, new_ef = compression.ef_compress_update(grads, state["ef"], mesh=mesh)

        with obs.annotate("repro_torch.train.optimizer"):
            new_params, new_opt, opt_metrics = adamw.adamw_update(
                grads, state["opt"], params, tcfg.optimizer, shardings=shardings, mesh=mesh)
        new_state = {"params": new_params, "opt": new_opt}
        if tcfg.ef_compression:
            new_state["ef"] = new_ef
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    def prepare(ctx, seq: int) -> None:
        """Build the step's shardings and plans for the mesh context ``ctx``
        and sequence length ``seq`` ahead of its first call: host work on a
        whole-shape ``meta`` skeleton, which the dry-run's count of live
        bytes must not take for the step's memory."""
        if ctx is not None:
            mesh_plan(ctx, int(seq))

    train_step.prepare = prepare
    return train_step
