"""Logical-axis sharding rules with shape-aware divisibility fallback.

Counterpart of ``repro/parallel/sharding.py``.  Every tensor names its
dims with *logical* axes ("batch", "heads", "ffn", "fsdp", ...) and
:func:`spec_for` resolves them onto the axes of a device mesh
(:class:`repro_torch.launch.mesh.Mesh`):

* a logical axis maps to one or more mesh axes (the rule table,
  :class:`Rules`; the reference's seven rulesets in :data:`RULESETS`);
* a mesh axis is applied only if it divides the dim size and was not
  already used by another dim of the same tensor;
* anything else falls back to replication.

A spec is a plain tuple with one entry per dim: a mesh axis name, a tuple
of them, or None (the reference's ``PartitionSpec``; ``tuple(P)`` of the
reference equals the port's spec).  Parameters resolve by *path*
(:func:`param_spec`, :func:`param_logical`), so models carry no
annotation tree; :func:`payload_plane_axes` gives the (n, k-words) axes a
packed QTensor records as its ``pspec`` (models/packing.py), through the
same table.

Two meshes use the rules.  The serving mesh: each rank holds its own
slice of the packed bit planes (``parallel/qmm_mesh.py``), every float
leaf is replicated, activations too, and :func:`constrain` is the
identity.  The training mesh: each rank holds the shard of every float32
master, moment and EF buffer that its coordinates name
(:class:`LeafSharding`, from :func:`train_state_shardings` of a
whole-shape state), and its share of the batch rows, split over
:func:`batch_axes`.  :func:`split_batch` declares the step's split for
its forward and backward:

* reductions over the batch span the batch axes (:func:`sum_over_batch`);
* on the tensor-parallel axis (:func:`tp_axis`: the mesh axis the rules
  give "heads", "ffn" or "vocab" that does not split the batch; "model"
  under ``TRAIN_RULES`` and ``TRAIN_RULES_HYBRID``, none under
  ``TRAIN_RULES_FSDP``) a leaf keeps its chunk of every dim whose logical
  axis is one of :data:`TP_LOGICAL` (:func:`leaf_plans`), and the compute
  splits along it: column-parallel projections on their n slice,
  row-parallel ones on their k slice, the vocab over the embedding and
  the head.  Every other axis of a leaf's spec is gathered
  (:func:`constrain_spec` -> :func:`gather_leaf`, whose backward sums the
  cotangent and keeps the shard: the reference's ZeRO-3 reduce-scatter);
* where the rules also map "seq" onto that axis (``TRAIN_RULES``), the
  residual stream between blocks is sequence-parallel: each rank holds
  its chunk of the sequence.  :func:`tp_enter` gathers the sequence before
  a column-parallel region (its backward reduce-scatters the partial
  cotangents in float32 and rounds their sum once), :func:`tp_reduce`
  reduce-scatters the partial sums of a row-parallel one into sequence
  shards (its backward all-gathers), and
  :func:`constrain` slices a whole activation named with "seq" into its
  shard.  Without "seq" on it (``TRAIN_RULES_HYBRID``) the two are the
  all-reduce pair: :func:`tp_enter` all-reduces the cotangent,
  :func:`tp_reduce` the partial sums.

MoE and SSM layers split on the same axis (:func:`leaf_plans`): an
expert's FFN keeps its "ffn" chunk, as a dense FFN does, and the Mamba2
mixer its "ssm_heads" chunk (``out_proj``'s rows, ``A_log``, ``D``,
``dt_bias``, the gated norm's scale).  ``in_proj``, ``conv_w`` and
``conv_b`` interleave the heads with B, C and dt along their "conv_dim",
so a contiguous chunk does not fall on head boundaries: they keep the
reference's layout in the state, are gathered whole and each rank
computes with its heads' part (:data:`_SSM_PARTIAL`).  Both layers need
the whole sequence (capacity drops go by position within an example; the
chunked scan runs along it): they gather it (:func:`tp_enter`, and
:func:`seq_gather` for the router's probabilities).
:func:`tp_all_reduce` sums a value each rank's own part of a split
computation reads (the gated norm's sum of squares).  Without a
tensor-parallel axis every leaf is gathered whole, as the axes of a
:class:`LeafPlan` of :func:`whole_plans` say.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

__all__ = ["Rules", "TRAIN_RULES", "SERVE_RULES", "SERVE_RULES_MOE", "SERVE_RULES_LOWBIT",
           "PREFILL_RULES", "TRAIN_RULES_FSDP", "TRAIN_RULES_HYBRID", "SERVE_RULES_EP",
           "RULESETS", "use_mesh", "active", "spec_for", "constrain", "constrain_spec",
           "param_spec", "param_shardings", "payload_plane_axes", "spec_axes",
           "batch_axes", "mesh_coord", "holds_first_copy", "LeafSharding", "shard_leaf",
           "gather_leaf", "split_batch", "batch_split", "sum_over_batch",
           "train_state_shardings", "TP_LOGICAL", "tp_axis", "param_logical", "LeafPlan",
           "leaf_plans", "whole_plans", "tp_split", "tp_size", "seq_parallel", "tp_enter",
           "tp_reduce", "tp_reduce_partial", "tp_gather_rows", "sum_over_tp", "max_over_tp",
           "seq_gather", "tp_all_reduce"]

AxisRule = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisRule, ...]


class Rules:
    """logical axis name -> mesh axes (in preference order)."""

    def __init__(self, table: Dict[str, AxisRule]):
        self.table = dict(table)

    def mesh_axes(self, logical: Optional[str]) -> Tuple[str, ...]:
        r = self.table.get(logical)
        if r is None:
            return ()
        return (r,) if isinstance(r, str) else tuple(r)

    def replaced(self, **kw) -> "Rules":
        t = dict(self.table)
        t.update(kw)
        return Rules(t)


# The reference's rulesets, table for table (see its comments for the
# measurements behind each choice).  Training: FSDP over "data", TP over
# "model", sequence-parallel hidden states, batch over pod x data.
TRAIN_RULES = Rules({
    "batch": ("pod", "data"),
    "seq": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "vocab": "model",
    "expert": None,
    "fsdp": "data",
    "ssm_heads": "model",
    "conv_dim": "model",
})

# Serving, dense archs: weight-stationary TP, batch over data.
SERVE_RULES = TRAIN_RULES.replaced(fsdp=None, seq=None)

# Serving, MoE archs: the expert ffn dim over both axes.
SERVE_RULES_MOE = SERVE_RULES.replaced(ffn=("model", "data"))

# Serving, offline-packed low-bit archs: the packed planes also split
# their k words over "data" (activations enter replicated and the only
# per-step collective is the integer partial-count all-reduce).
# Column-parallel planes (wq/wk/wv/gate/up) n-shard over "model";
# row-parallel planes (wo/down) k-word-shard over "model".
SERVE_RULES_LOWBIT = SERVE_RULES.replaced(fsdp="data")

# Prefill: serving with the residual stream sequence-sharded.
PREFILL_RULES = SERVE_RULES.replaced(seq="model")

# FSDP-only training: no tensor parallelism.
TRAIN_RULES_FSDP = TRAIN_RULES.replaced(
    batch=("pod", "data", "model"),
    seq=None, heads=None, kv_heads=None, ffn=None, vocab="model",
    fsdp=("data", "model"), ssm_heads=None, conv_dim=None)

# Hybrid: data-parallel attention, tensor-parallel expert FFNs.
TRAIN_RULES_HYBRID = TRAIN_RULES.replaced(seq=None, heads=None, kv_heads=None)

# Expert parallelism for serving archs whose expert count divides "model".
SERVE_RULES_EP = SERVE_RULES.replaced(expert="model", ffn="data",
                                      heads=None, kv_heads=None)

RULESETS = {
    "train": TRAIN_RULES,
    "prefill": PREFILL_RULES,
    "serve": SERVE_RULES,
    "serve_lowbit": SERVE_RULES_LOWBIT,
    "serve_ep": SERVE_RULES_EP,
    "train_fsdp": TRAIN_RULES_FSDP,
    "train_hybrid": TRAIN_RULES_HYBRID,
}


class _Active:
    """The active mesh and ruleset; ``axis_sizes`` maps each mesh axis
    name to its size."""

    def __init__(self, mesh, rules: Rules):
        self.mesh = mesh
        self.rules = rules
        self.axis_sizes = dict(zip(mesh.axis_names, mesh.shape))


_ACTIVE: contextvars.ContextVar[Optional[_Active]] = \
    contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh=None, rules: Rules = TRAIN_RULES):
    """Make ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) and
    ``rules`` the active context for the block: ``ops.qmm`` / ``ops.qconv``
    then dispatch sharded containers to the mesh path, and packing
    records and slices by the rules.  ``mesh=None`` is a no-op context."""
    if mesh is None:
        yield
        return
    tok = _ACTIVE.set(_Active(mesh, rules))
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


def active() -> Optional[_Active]:
    """The active mesh context, or None outside :func:`use_mesh`."""
    return _ACTIVE.get()


def spec_for(shape: Sequence[int], logical_axes: Sequence[Optional[str]],
             ctx: Optional[_Active] = None) -> Spec:
    """Resolve logical axes -> a spec tuple with divisibility fallback."""
    ctx = ctx or active()
    if ctx is None:
        return (None,) * len(shape)
    assert len(shape) == len(logical_axes), (shape, logical_axes)
    used = set()
    out = []
    for dim, logical in zip(shape, logical_axes):
        assigned = []
        for ax in ctx.rules.mesh_axes(logical):
            size = ctx.axis_sizes.get(ax)
            if size is None or ax in used:
                continue
            cur = 1
            for a in assigned:
                cur *= ctx.axis_sizes[a]
            if dim % (cur * size) == 0:
                assigned.append(ax)
                used.add(ax)
        if not assigned:
            out.append(None)
        elif len(assigned) == 1:
            out.append(assigned[0])
        else:
            out.append(tuple(assigned))
    return tuple(out)


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Sharding constraint on an activation by logical axes.  The identity
    but on a sequence-parallel training split (:func:`split_batch` with
    ``sp``), where a tensor named with "seq" is made this rank's sequence
    shard: a whole one (its "seq" dim the step's length) is sliced, and its
    backward all-gathers the cotangent; a shard passes.  The other logical
    axes need no data movement here: a tensor split over "heads", "ffn" or
    "vocab" comes out of a column-parallel projection already split, and
    serving replicates every activation."""
    split = batch_split()
    if split is None or not split.sp or "seq" not in logical_axes:
        return x
    dim = list(logical_axes).index("seq")
    size = x.shape[dim]
    if size == split.seq // split.tp_size:
        return x
    if size != split.seq:
        raise ValueError(f"constrain: dim {dim} of {tuple(x.shape)} is neither the step's "
                         f"sequence ({split.seq}) nor its shard")
    return _SeqSlice.apply(x, dim, split)


def constrain_spec(x: torch.Tensor, spec: Spec,
                   sum_axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """A parameter's compute copy constrained to ``spec``: ``x`` is this
    rank's shard and the result gathered over every axis of ``spec``
    (:func:`gather_leaf`, whose backward sums the cotangent over
    ``sum_axes``, default the batch axes, and keeps this rank's shard: the
    ZeRO-3 reduce-scatter).  The train step passes a :class:`LeafPlan`'s
    ``gather`` spec, which leaves out the tensor-parallel axis of a leaf
    whose compute splits along it.  Outside a training mesh
    (:func:`split_batch`), the identity."""
    split = batch_split()
    if split is None:
        return x
    return gather_leaf(x, spec, split.mesh, split.axes if sum_axes is None else sum_axes)


# ---------------------------------------------------------------------------
# The training mesh: batch axes, leaf shards, gathers and reduce-scatters
# ---------------------------------------------------------------------------

def spec_axes(entry: AxisRule) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, in order (major first)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def batch_axes(ctx: Optional[_Active] = None) -> Tuple[str, ...]:
    """The mesh axes the active rules split the batch over: the "batch"
    entry of :func:`spec_for` on a length that every axis divides (the
    mesh's size), so no axis drops out for divisibility.  ``TRAIN_RULES``:
    ("pod", "data") as the mesh has them; ``TRAIN_RULES_FSDP``: all three.
    A global batch the batch shards do not divide is dealt unevenly by the
    data pipeline (``data.pipeline.host_rows``)."""
    ctx = ctx or active()
    if ctx is None:
        return ()
    n = 1
    for size in ctx.axis_sizes.values():
        n *= size
    return spec_axes(spec_for((n,), ("batch",), ctx)[0])


def mesh_coord(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's chunk index, chunk count) over ``axes``, first major:
    over a spec entry's axes, the chunk of the dim this rank holds; over
    :func:`batch_axes`, its batch coordinate and the batch shard count
    (the arguments of ``data.pipeline.host_rows``)."""
    idx, count = 0, 1
    for ax in axes:
        idx = idx * mesh.axis_size(ax) + mesh.axis_index(ax)
        count *= mesh.axis_size(ax)
    return idx, count


def holds_first_copy(spec: Spec, mesh) -> bool:
    """True on the one rank per shard of a leaf of ``spec`` whose
    coordinates are 0 on every mesh axis the spec does not use: the rank
    that counts the shard where each shard must count once (a global
    norm)."""
    used = {a for e in spec for a in spec_axes(e)}
    return all(mesh.axis_index(ax) == 0 for ax in mesh.axis_names if ax not in used)


# The logical axes whose compute a training step splits over its
# tensor-parallel axis (:func:`leaf_plans`).
TP_LOGICAL = ("heads", "kv_heads", "ffn", "vocab", "ssm_heads")

# Mamba2 leaves the rules name "conv_dim" that a tensor-parallel step
# treats otherwise (module docstring): the gated norm's scale spans
# d_inner, whose chunks fall on head boundaries, so it keeps its chunk as
# "ssm_heads"; in_proj's columns [z | x | B | C | dt] and the conv's
# channels [x | B | C] are gathered whole, and each rank computes with
# its heads' part of them (their gradients sum over the axis).
_SSM_HEAD_NORM = re.compile(r"mixer/norm$")
_SSM_PARTIAL = re.compile(r"mixer/(in_proj/w|conv_w|conv_b)$")


def tp_axis(ctx: Optional[_Active] = None) -> Optional[str]:
    """The tensor-parallel axis of a training step under the active rules:
    the first mesh axis of size > 1 that the rules give one of
    :data:`TP_LOGICAL` and that does not split the batch (:func:`batch_axes`);
    None without one.  ``TRAIN_RULES`` and ``TRAIN_RULES_HYBRID``: "model";
    ``TRAIN_RULES_FSDP``: None ("model" splits the batch there)."""
    ctx = ctx or active()
    if ctx is None:
        return None
    batch = set(batch_axes(ctx))
    for logical in TP_LOGICAL:
        for ax in ctx.rules.mesh_axes(logical):
            if ax not in batch and ctx.axis_sizes.get(ax, 1) > 1:
                return ax
    return None


def tp_size(ctx: Optional[_Active] = None) -> int:
    """The size of :func:`tp_axis` (1 without one, and off the mesh): the
    ``ShardLayout.tp`` of a training step."""
    ctx = ctx or active()
    ax = tp_axis(ctx)
    return ctx.axis_sizes[ax] if ax else 1


def seq_parallel(ctx: Optional[_Active] = None, tp: Optional[str] = None) -> bool:
    """True when the rules map "seq" onto the tensor-parallel axis ``tp``
    (default :func:`tp_axis`): the residual stream then holds sequence
    shards between blocks (``TRAIN_RULES``)."""
    ctx = ctx or active()
    tp = tp if tp is not None else tp_axis(ctx)
    return ctx is not None and tp is not None and tp in ctx.rules.mesh_axes("seq")


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How a training step computes with one leaf: ``gather``, the spec
    its compute copy is gathered over (the leaf's spec without the
    tensor-parallel axis where the leaf keeps its chunk); ``sum_axes``,
    the axes its gradient is summed over (the batch axes, and the
    tensor-parallel axis where the leaf is whole on every rank of it but
    each computes with a part: sequence shards, a rank's heads);
    ``split``, the logical axis whose chunk the leaf keeps, or None."""
    gather: Spec
    sum_axes: Tuple[str, ...]
    split: Optional[str] = None

    @property
    def gathered(self) -> bool:
        return any(e is not None for e in self.gather)


def whole_plans(p_sh, ctx: Optional[_Active] = None):
    """The :class:`LeafPlan` tree of a step with no tensor-parallel split:
    every leaf gathered over its whole spec, every gradient summed over
    the batch axes."""
    from repro_torch import tree

    axes = batch_axes(ctx)
    return tree.tree_map(lambda sh: LeafPlan(sh.spec, axes), p_sh)


def leaf_plans(p_sh, ctx: Optional[_Active] = None, *, sp: bool):
    """The :class:`LeafPlan` tree of a tensor-parallel step over the params'
    :class:`LeafSharding` tree ``p_sh``: a leaf keeps its chunk on the
    :func:`tp_axis` along every dim whose logical axis (:func:`param_logical`;
    the Mamba2 norm's "conv_dim" read as "ssm_heads") is in
    :data:`TP_LOGICAL` and whose spec entry leads with that axis, and is
    gathered over every other axis of its spec.  A leaf that keeps no
    chunk sums its gradient over the tensor-parallel axis too when ``sp``
    (each rank computes with its sequence shard), and so do the Mamba2
    leaves of :data:`_SSM_PARTIAL` when the heads split (each rank
    computes with its heads' columns).  Returns (plans, the set of
    logical axes some leaf split)."""
    from repro_torch import tree

    ctx = ctx or active()
    tp = tp_axis(ctx)
    axes = batch_axes(ctx)

    def chunk(path, sh):
        logical = param_logical(path, sh) or (None,) * len(sh.spec)
        if _SSM_HEAD_NORM.search(path):
            logical = tuple("ssm_heads" if lg == "conv_dim" else lg for lg in logical)
        gather, split = [], None
        for entry, lg in zip(sh.spec, logical):
            ax = spec_axes(entry)
            if tp in ax and lg in TP_LOGICAL:
                if ax[0] != tp:
                    raise NotImplementedError(f"{path}: spec entry {entry} splits "
                                              f"{lg} with {tp} not its major axis")
                split = lg
                rest = ax[1:]
                entry = None if not rest else rest[0] if len(rest) == 1 else rest
            gather.append(entry)
        return tuple(gather), split

    chunks = {path: chunk(path, sh) for path, sh in tree.flatten_with_paths(p_sh)}
    seen = frozenset(split for _, split in chunks.values() if split is not None)

    def plan(path, sh):
        gather, split = chunks[path]
        if split is not None:
            return LeafPlan(gather, axes, split)
        partial = sp or ("ssm_heads" in seen and _SSM_PARTIAL.search(path) is not None)
        return LeafPlan(gather, axes + ((tp,) if partial else ()))

    return tree.map_with_paths(plan, p_sh), seen


@dataclasses.dataclass(frozen=True, eq=False)
class LeafSharding:
    """Where one leaf of a train state lives on the training mesh: its
    ``spec`` and its whole (logical) ``shape``.  Each rank holds the chunk
    of every sharded dim its coordinates name (:meth:`shard`).  It equals
    another of the same spec and shape, and its spec tuple (the
    reference's ``NamedSharding`` compares by spec), so a tree of them
    compares with a tree of :func:`param_spec` results."""
    spec: Spec
    shape: Tuple[int, ...]

    def __eq__(self, other):
        if isinstance(other, LeafSharding):
            return (self.spec, self.shape) == (other.spec, other.shape)
        if isinstance(other, tuple):
            return self.spec == other
        return NotImplemented

    def __hash__(self):
        return hash(self.spec)

    @property
    def sharded(self) -> bool:
        return any(e is not None for e in self.spec)

    def counts(self, mesh) -> Tuple[int, ...]:
        return tuple(mesh_coord(mesh, spec_axes(e))[1] if e is not None else 1
                     for e in self.spec)

    def local_shape(self, mesh) -> Tuple[int, ...]:
        return tuple(d // c for d, c in zip(self.shape, self.counts(mesh)))

    def start(self, mesh, dim: int) -> int:
        """The index of this rank's first element along ``dim``."""
        idx, count = mesh_coord(mesh, spec_axes(self.spec[dim]))
        return idx * (self.shape[dim] // count)

    def shard(self, x: torch.Tensor, mesh) -> torch.Tensor:
        """This rank's chunk of the whole leaf ``x`` (a copy)."""
        return shard_leaf(x, self.spec, mesh)

    def gather(self, local: torch.Tensor, mesh) -> torch.Tensor:
        """The whole leaf from every rank's ``local`` chunk (collective;
        no autograd)."""
        return _gather(local, self.spec, mesh)


def shard_leaf(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's slice of the whole leaf ``x`` along the spec's axes, as
    a contiguous copy."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx, count = mesh_coord(mesh, spec_axes(entry))
        chunk = x.shape[dim] // count
        x = x.narrow(dim, idx * chunk, chunk)
    return x.clone(memory_format=torch.contiguous_format)


def _gather(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    x = local
    for dim, entry in enumerate(spec):
        if entry is not None:
            x = mesh.all_gather_axes(x, spec_axes(entry), dim)
    return x


def _reduce_to_shard(g: torch.Tensor, spec: Spec, mesh,
                     axes: Sequence[str]) -> torch.Tensor:
    """``shard_leaf(sum over the batch axes of g)``: each dim's chunks along
    axes that are not batch axes are picked locally first, then the batch
    axes of the spec reduce-scatter, then the batch axes the spec does not
    use all-reduce."""
    axes = tuple(axes)
    scatter = []
    for dim, entry in enumerate(spec):
        ax = spec_axes(entry)
        if not ax:
            continue
        sizes = [mesh.axis_size(a) for a in ax]
        chunk = g.shape[dim] // math.prod(sizes)
        # view the dim as (s_1, ..., s_j, chunk); pick non-batch axes' coords
        sub = g.reshape(g.shape[:dim] + tuple(sizes) + (chunk,) + g.shape[dim + 1:])
        keep = []
        for j in reversed(range(len(ax))):
            if ax[j] in axes:
                keep.append(ax[j])
            else:
                sub = sub.narrow(dim + j, mesh.axis_index(ax[j]), 1)
        keep.reverse()
        sub = sub.reshape(g.shape[:dim] + (-1,) + g.shape[dim + 1:])
        g = sub
        if keep:
            scatter.append((dim, tuple(keep)))
    for dim, ax in scatter:
        g = mesh.reduce_scatter_sum(g, ax, dim)
    used = {a for e in spec for a in spec_axes(e)}
    rest = [a for a in axes if a not in used]
    if rest:
        g = mesh.all_reduce_axes_(g.contiguous(), rest, "sum")
    return g.contiguous()


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, spec, mesh, axes):
        ctx.spec, ctx.mesh, ctx.axes = spec, mesh, axes
        return _gather(local, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return _reduce_to_shard(g, ctx.spec, ctx.mesh, ctx.axes), None, None, None


def gather_leaf(local: torch.Tensor, spec: Spec, mesh,
                axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """The whole leaf gathered from every rank's ``local`` shard, in
    ``local``'s dtype (bf16 shards make a bf16 wire).  Backward: the
    cotangent summed over the batch ``axes`` only (default: the active
    rules' :func:`batch_axes`) and this rank's slice kept.  Ranks along an
    axis that is not a batch axis see the same rows and compute the same
    cotangent, so summing over it would count it twice."""
    if axes is None:
        axes = batch_axes()
    if not any(e is not None for e in spec) and not axes:
        return local
    return _GatherLeaf.apply(local, tuple(spec), mesh, tuple(axes))


class _BatchSplit:
    """The batch rows of the running forward are split over ``axes`` of
    ``mesh``: reductions over the batch (activation statistics, the MoE
    load balance, the loss's token count) sum over them.  ``tp``: the
    tensor-parallel axis (or None), ``tp_size`` its size, ``split`` the
    logical axes whose compute splits along it (:func:`leaf_plans`),
    ``sp`` whether the residual stream holds sequence shards of the
    step's ``seq`` tokens.  ``thread``: the one that declared it."""

    def __init__(self, mesh, axes: Tuple[str, ...], tp: Optional[str] = None,
                 split: Sequence[str] = (), sp: bool = False, seq: int = 0):
        self.mesh, self.axes = mesh, tuple(axes)
        self.tp = tp
        self.tp_size = mesh.axis_size(tp) if tp else 1
        self.split = frozenset(split) if tp else frozenset()
        self.sp = bool(sp and tp)
        self.seq = int(seq)
        self.thread = threading.get_ident()

    @property
    def tp_index(self) -> int:
        """This rank's coordinate on the tensor-parallel axis."""
        return self.mesh.axis_index(self.tp) if self.tp else 0

    def splits(self, logical: str) -> bool:
        """True when the compute of ``logical`` ("heads", "ffn", "vocab")
        splits over the tensor-parallel axis."""
        return logical in self.split

    def reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return self.mesh.all_reduce_axes_(t, self.axes, op)

    def reduce_all(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Over the batch axes and the tensor-parallel axis: a reduction
        whose elements the step splits over both (a row-parallel
        projection's input, the residual stream's sequence shards)."""
        return self.mesh.all_reduce_axes_(t, self.axes + ((self.tp,) if self.tp else ()), op)

    def reduce_tp(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return self.mesh.all_reduce_axes_(t, (self.tp,), op) if self.tp else t


# Process-wide, not a context variable: autograd runs a CUDA backward, and
# with it remat's recompute of the forward, on a thread of its own, where
# a context variable set by the step would read as unset.  So while a step
# runs, every thread of the process sees its split (split_batch's
# docstring says what that asks of the process).
_SPLIT: List[Optional[_BatchSplit]] = [None]


@contextlib.contextmanager
def split_batch(mesh, axes: Sequence[str], *, tp: Optional[str] = None,
                split: Sequence[str] = (), sp: bool = False, seq: int = 0):
    """Declare, for the block, that each rank's batch is its share of the
    global batch along the batch ``axes`` of ``mesh`` (the train step's
    forward and backward on the training mesh, the backward's threads
    included).  Axes of size 1 split nothing and are dropped: a batch no
    axis splits reduces as on one device.  ``mesh=None`` (one device) is a
    no-op context.

    ``tp`` names the tensor-parallel axis of the step and ``split`` the
    logical axes whose compute splits along it (:func:`leaf_plans`);
    ``sp``: the residual stream holds sequence shards of ``seq`` tokens
    (module docstring).  A ``tp`` of size 1 splits nothing.

    One caller at a time: the split is the process's, so any other thread
    that quantizes a projection or gathers a leaf while the block runs
    (an ``Engine`` in the same process) would join the step's collectives.
    A process that trains on the mesh runs nothing else that does; a
    second split declared from another thread while one is active
    raises."""
    if mesh is None:
        yield
        return
    prev = _SPLIT[0]
    if prev is not None and prev.thread != threading.get_ident():
        raise RuntimeError("split_batch: another thread's training step is running")
    if tp is not None and mesh.axis_size(tp) == 1:
        tp = None
    _SPLIT[0] = _BatchSplit(mesh, tuple(ax for ax in axes if mesh.axis_size(ax) > 1),
                            tp=tp, split=split, sp=sp, seq=seq)
    try:
        yield
    finally:
        _SPLIT[0] = prev


def batch_split() -> Optional[_BatchSplit]:
    """The active :func:`split_batch`, or None (one device, or serving)."""
    return _SPLIT[0]


def tp_split(logical: Optional[str] = None) -> Optional[_BatchSplit]:
    """The active split when it splits the compute of ``logical`` over a
    tensor-parallel axis (any logical axis when None), else None: what
    the models ask before they take the tensor-parallel path."""
    split = _SPLIT[0]
    if split is None or split.tp is None:
        return None
    if logical is not None and not split.splits(logical):
        return None
    return split


class _SumOverBatch(torch.autograd.Function):
    """Forward: the sum over the batch axes.  Backward: the identity: each
    rank's rows reach their parameters through its own forward, and the
    parameter gradients are summed over the batch axes afterwards."""

    @staticmethod
    def forward(ctx, t, split):
        return split.reduce(t, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_batch(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the batch axes of the active :func:`split_batch`
    (autograd: the identity backward of :class:`_SumOverBatch`); ``t``
    itself outside one.  A reduction whose elements the tensor-parallel
    axis splits too sums over both (``_BatchSplit.reduce_all``: a
    row-parallel projection's statistics; the norm scales' gradients,
    ``train_step._sum_replicated``)."""
    split = batch_split()
    if split is None or not split.axes:
        return t
    return _SumOverBatch.apply(t, split)


class _SumOverTP(torch.autograd.Function):
    """Forward: the sum over the tensor-parallel axis.  Backward: the
    identity: every rank along it computes the same result from the sum,
    so each one's cotangent is the cotangent of its own term."""

    @staticmethod
    def forward(ctx, t, split):
        return split.reduce_tp(t.contiguous(), "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_tp(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the tensor-parallel axis of the active split
    (the identity backward): the vocab-parallel loss's sum of
    exponentials and target logit."""
    split = tp_split()
    return t if split is None else _SumOverTP.apply(t, split)


def max_over_tp(t: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the tensor-parallel axis (no gradient: the
    loss takes it under ``detach``)."""
    split = tp_split()
    return t if split is None else split.reduce_tp(t.detach().contiguous(), "max")


# ---------------------------------------------------------------------------
# Tensor- and sequence-parallel boundaries
# ---------------------------------------------------------------------------

def _wide(dtype: torch.dtype) -> torch.dtype:
    """float32 for a narrower float dtype (bf16), else ``dtype``: the dtype
    a column-parallel region's input is handed on in (:func:`tp_enter`)."""
    return torch.promote_types(dtype, torch.float32)


class _SeqGather(torch.autograd.Function):
    """Sequence shards -> the whole sequence (all-gather over the
    tensor-parallel axis, in ``x``'s dtype), handed on in float32 (or
    wider); backward: the partial cotangents summed in that dtype and
    scattered back into sequence shards (reduce-scatter), cast to ``x``'s
    dtype once."""

    @staticmethod
    def forward(ctx, x, dim, split):
        ctx.dim, ctx.split, ctx.dtype = dim, split, x.dtype
        return split.mesh.all_gather_axes(x.contiguous(), (split.tp,), dim).to(_wide(x.dtype))

    @staticmethod
    def backward(ctx, g):
        g = ctx.split.mesh.reduce_scatter_sum(g.to(_wide(ctx.dtype)).contiguous(),
                                              (ctx.split.tp,), ctx.dim)
        return g.to(ctx.dtype), None, None


class _SeqScatter(torch.autograd.Function):
    """Partial sums over the tensor-parallel axis -> this rank's sequence
    shard of their sum (reduce-scatter); backward: all-gather."""

    @staticmethod
    def forward(ctx, x, dim, split):
        ctx.dim, ctx.split = dim, split
        return split.mesh.reduce_scatter_sum(x.contiguous(), (split.tp,), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.split.mesh.all_gather_axes(g.contiguous(), (ctx.split.tp,), ctx.dim), \
            None, None


class _SeqSlice(torch.autograd.Function):
    """A whole (replicated) activation -> this rank's sequence shard;
    backward: all-gather."""

    @staticmethod
    def forward(ctx, x, dim, split):
        ctx.dim, ctx.split = dim, split
        chunk = x.shape[dim] // split.tp_size
        return x.narrow(dim, split.tp_index * chunk, chunk).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.split.mesh.all_gather_axes(g.contiguous(), (ctx.split.tp,), ctx.dim), \
            None, None


class _TPCopy(torch.autograd.Function):
    """The input of a column-parallel region without sequence shards:
    forward ``x`` in float32 (or wider), backward the all-reduce of the
    partial cotangents in that dtype, cast to ``x``'s dtype once."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split, ctx.dtype = split, x.dtype
        wide = _wide(x.dtype)
        return x.to(wide) if x.dtype != wide else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.split.reduce_tp(g.to(_wide(ctx.dtype)).contiguous(), "sum").to(ctx.dtype), None


class _TPSum(torch.autograd.Function):
    """Partial sums of a row-parallel region without sequence shards:
    forward the all-reduce, backward the identity."""

    @staticmethod
    def forward(ctx, x, split):
        return split.reduce_tp(x.contiguous(), "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_enter(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The input of a column-parallel region, the same on every rank of
    the tensor-parallel axis: on a sequence-parallel split this rank's
    sequence shard (``dim``) gathered whole (the wire in ``x``'s dtype),
    else ``x`` itself; the backward sums the ranks' partial cotangents
    (into sequence shards under ``sp``).  The result is float32 (or
    ``x``'s wider dtype) with ``x``'s values, so each consumer's partial
    cotangent stays float32: the partials are summed in float32, over the
    region's projections and over the ranks, and cast to ``x``'s dtype
    once (one device rounds each projection's cotangent of ``x`` and then
    their sum; the two agree within that rounding).  A consumer casts what
    it computes back to ``x``'s dtype where one device would.  ``x``
    itself off a tensor-parallel split."""
    split = tp_split()
    if split is None:
        return x
    if split.sp:
        return _SeqGather.apply(x, dim, split)
    return _TPCopy.apply(x, split)


def tp_reduce(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Partial sums over the tensor-parallel axis (a row-parallel
    projection's float output, the vocab-parallel embedding) -> their sum:
    this rank's sequence shard along ``dim`` under ``sp`` (reduce-scatter;
    backward all-gather), else whole (all-reduce; backward the identity).
    ``x`` itself off a tensor-parallel split."""
    split = tp_split()
    if split is None:
        return x
    if split.sp:
        return _SeqScatter.apply(x, dim, split)
    return _TPSum.apply(x, split)


class _SeqGatherSame(torch.autograd.Function):
    """Sequence shards -> the whole sequence (all-gather over the
    tensor-parallel axis), for consumers that compute the same thing on
    every rank of it; backward: this rank's shard of the cotangent, which
    every rank holds whole and alike."""

    @staticmethod
    def forward(ctx, x, dim, split):
        ctx.dim, ctx.split = dim, split
        return split.mesh.all_gather_axes(x.contiguous(), (split.tp,), dim)

    @staticmethod
    def backward(ctx, g):
        chunk = g.shape[ctx.dim] // ctx.split.tp_size
        return g.narrow(ctx.dim, ctx.split.tp_index * chunk, chunk).contiguous(), None, None


def seq_gather(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's sequence shard (``dim``) gathered whole, in ``x``'s
    dtype, for consumers that compute the same on every rank of the
    tensor-parallel axis (the MoE router's probabilities: routing,
    dispatch, combine and aux loss alike on every rank); the backward keeps
    this rank's shard of the cotangent, no collective.  ``x`` itself off a
    sequence-parallel split."""
    split = tp_split()
    if split is None or not split.sp:
        return x
    return _SeqGatherSame.apply(x, dim, split)


class _TPAllReduce(torch.autograd.Function):
    """Forward and backward: the sum over the tensor-parallel axis."""

    @staticmethod
    def forward(ctx, t, split):
        ctx.split = split
        return split.reduce_tp(t.contiguous(), "sum")

    @staticmethod
    def backward(ctx, g):
        return ctx.split.reduce_tp(g.contiguous(), "sum"), None


def tp_all_reduce(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the tensor-parallel axis where each rank's own part
    of a split computation reads the sum (the Mamba2 gated norm's sum of
    squares over d_inner): the backward sums the ranks' cotangents too.
    ``t`` itself off a tensor-parallel split."""
    split = tp_split()
    return t if split is None else _TPAllReduce.apply(t, split)


def tp_reduce_partial(part: torch.Tensor, lead: Sequence[int], split) -> torch.Tensor:
    """No autograd: the partial (m, n) of a row-parallel projection whose
    m rows are ``lead`` (the last lead dim the sequence) reduced over the
    tensor-parallel axis -> (m / tp, n) under ``sp`` (reduce-scatter of
    the sequence), (m, n) else (all-reduce).  ``ops.quantized_matmul``
    reduces the int32 partial counts with it before the eq. (2)
    epilogue."""
    lead = tuple(int(d) for d in lead)
    if split.sp:
        t = part.reshape(lead + (part.shape[-1],))
        t = split.mesh.reduce_scatter_sum(t, (split.tp,), len(lead) - 1)
        return t.reshape(-1, part.shape[-1])
    return split.reduce_tp(part.contiguous(), "sum")


def tp_gather_rows(g: torch.Tensor, lead: Sequence[int], split) -> torch.Tensor:
    """No autograd: the inverse of :func:`tp_reduce_partial`'s layout, for
    its backward: the cotangent of this rank's (m / tp, n) sequence shard
    gathered into the (m, n) of every row under ``sp``; ``g`` else."""
    if not split.sp:
        return g
    lead = tuple(int(d) for d in lead)
    local = lead[:-1] + (lead[-1] // split.tp_size,)
    t = g.reshape(local + (g.shape[-1],))
    t = split.mesh.all_gather_axes(t.contiguous(), (split.tp,), len(lead) - 1)
    return t.reshape(-1, g.shape[-1])


# ---------------------------------------------------------------------------
# Parameter sharding by path
# ---------------------------------------------------------------------------

# (path regex, logical axes per dim) — first match wins (with a rank
# check).  Paths look like "blocks/0/mixer/wq/payload/plus".  The
# payload entries cover packed projection weights: planes are (n, k/32)
# words with n the output dim, scales (n,).
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"embed$",              ("vocab", "fsdp")),
    (r"lm_head/w$",          ("fsdp", "vocab")),
    (r"(wq|wk|wv)/w$",       ("fsdp", "heads")),
    (r"wo/w$",               ("heads", "fsdp")),
    (r"router$",             ("fsdp", None)),
    (r"(gate|up)/w$",        ("fsdp", "ffn")),
    (r"down/w$",             ("ffn", "fsdp")),
    (r"in_proj/w$",          ("fsdp", "conv_dim")),
    (r"out_proj/w$",         ("ssm_heads", "fsdp")),
    (r"conv_w$",             (None, "conv_dim")),
    (r"conv_b$",             ("conv_dim",)),
    (r"(A_log|D|dt_bias)$",  ("ssm_heads",)),
    (r"norm$",               ("conv_dim",)),
    # ---- packed bit planes (serving) ----
    (r"(wq|wk|wv)/(?:payload/)?(plus|minus|bits)$", ("heads", "fsdp")),
    (r"(wq|wk|wv)/scale$",   ("heads",)),
    (r"wo/(?:payload/)?(plus|minus|bits)$", (None, "heads")),
    (r"wo/scale$",           (None,)),
    (r"(gate|up)/(?:payload/)?(plus|minus|bits)$", ("ffn", "fsdp")),
    (r"(gate|up)/scale$",    ("ffn",)),
    (r"(gate|up)/scale$",    ("expert", "ffn")),
    (r"down/(?:payload/)?(plus|minus|bits)$", (None, "ffn")),
    (r"down/scale$",         (None,)),
    (r"down/scale$",         ("expert", None)),
    (r"in_proj/(?:payload/)?(plus|minus|bits)$", ("conv_dim", "fsdp")),
    (r"in_proj/scale$",      ("conv_dim",)),
    (r"out_proj/(?:payload/)?(plus|minus|bits)$", (None, "ssm_heads")),
    (r"out_proj/scale$",     (None,)),
)

# MoE expert tensors are 3-D; matched before the 2-D rules by rank.
_PARAM_RULES_3D: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"(gate|up)/w$",        ("expert", "fsdp", "ffn")),
    (r"down/w$",             ("expert", "ffn", "fsdp")),
    (r"(gate|up)/(?:payload/)?(plus|minus|bits)$", ("expert", "ffn", None)),
    (r"down/(?:payload/)?(plus|minus|bits)$", ("expert", None, "ffn")),
)


def _path_str(path) -> str:
    """A leaf path as "a/b/0/c": the port's ``tree.py`` paths are that
    string already; a sequence of keys is joined."""
    if isinstance(path, str):
        return path
    return "/".join(str(p) for p in path)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in leaf.shape)


def _match_logical(s: str, ndim: int) -> Optional[Tuple[Optional[str], ...]]:
    """The logical axes of the leaf at path ``s`` of rank ``ndim`` by the
    rule tables (a period-stacked leaf's leading dim None), or None."""
    if ndim == 3:
        for pat, axes in _PARAM_RULES_3D:
            if re.search(pat, s):
                return axes
    for pat, axes in _PARAM_RULES:
        if re.search(pat, s) and len(axes) == ndim:
            return axes
    # period-stacked params carry a leading period dim
    if ndim >= 1 and re.search(r"blocks/", s):
        for pat, axes in (_PARAM_RULES_3D if ndim == 4 else ()):
            if re.search(pat, s):
                return (None,) + axes
        for pat, axes in _PARAM_RULES:
            if re.search(pat, s) and len(axes) == ndim - 1:
                return (None,) + axes
    return None


def _match_rules(s: str, leaf, ndim: int, ctx) -> Optional[Spec]:
    logical = _match_logical(s, ndim)
    return None if logical is None else spec_for(_shape(leaf), logical, ctx)


def param_logical(path, leaf) -> Optional[Tuple[Optional[str], ...]]:
    """The logical axes the rule tables give the parameter ``leaf`` at
    ``path`` (None for a period-stacked leaf's leading dim), or None when
    no rule matches."""
    return _match_logical(_path_str(path), len(_shape(leaf)))


def param_spec(path, leaf, ctx: Optional[_Active] = None) -> Spec:
    """The spec of the parameter ``leaf`` (anything with a ``shape``) at
    ``path``; replicated when no rule matches."""
    s = _path_str(path)
    ndim = len(_shape(leaf))
    # Direct rules first: the packed QTensor scale leaves ("wq/scale",
    # (n,)) have their own entries and must not be taken for moments.
    spec = _match_rules(s, leaf, ndim, ctx)
    if spec is not None:
        return spec
    # int8 optimizer moments (optim.adamw.Q8): q/scale keep the
    # parameter's rank, so the parameter's own rule applies.
    if s.endswith("/.q") or s.endswith("/q") \
            or s.endswith("/.scale") or s.endswith("/scale"):
        spec = _match_rules(s.rsplit("/", 1)[0], leaf, ndim, ctx)
        if spec is not None:
            return spec
    return (None,) * ndim


def _single_axis(entry: AxisRule) -> Optional[str]:
    """Collapse a (possibly multi-axis) spec entry to one mesh axis name:
    the mesh-aware qmm partitions each payload-plane dim over at most one
    axis; the first (highest-preference) one wins."""
    if entry is None or isinstance(entry, str):
        return entry
    return entry[0] if entry else None


def payload_plane_axes(path: str, plane, ctx: Optional[_Active] = None
                       ) -> Optional[Tuple[Optional[str], Optional[str]]]:
    """Mesh axes of a packed payload plane's trailing (n, k-words) dims.

    ``path`` is the joined tree path of the plane leaf (e.g.
    ``"blocks/0/mixer/wq/payload/plus"``), ``plane`` the (..., n, kw)
    tensor (or anything with its shape).  Resolves through the table of
    :func:`param_spec` and returns the last two entries collapsed to
    single axis names, or None when no rule matches, no mesh is active or
    both dims replicate."""
    ctx = ctx or active()
    if ctx is None:
        return None
    spec = _match_rules(path, plane, len(_shape(plane)), ctx)
    if spec is None or len(spec) < 2:
        return None
    n_ax, k_ax = (_single_axis(e) for e in spec[-2:])
    if n_ax is None and k_ax is None:
        return None
    return (n_ax, k_ax)


def param_shardings(params, ctx: Optional[_Active] = None):
    """The tree of :class:`LeafSharding` matching ``params``, whose leaves
    have their whole shapes (tensors, ``meta`` tensors): each leaf's
    :func:`param_spec` and shape.  A train state's is
    :func:`train_state_shardings`."""
    from repro_torch import tree

    ctx = ctx or active()
    assert ctx is not None, "param_shardings requires use_mesh()"
    return tree.map_with_paths(
        lambda path, leaf: LeafSharding(param_spec(path, leaf, ctx), _shape(leaf)), params)


def train_state_shardings(state, ctx: Optional[_Active] = None):
    """:func:`param_shardings` of a whole-shape train state: ``params`` by
    path; every moment and EF buffer as its parameter (the reference's
    moment paths resolve to their parameter's rule; here the parameter's
    path is used, so a norm scale's moment shards with it); an int8 moment
    (``Q8``) keeps its ``q`` on the parameter's spec and resolves its
    ``scale`` by the parameter's rule on the scale's own shape, which
    replicates a block count the axes do not divide; the step replicated.
    This is what ``Checkpointer.save`` / ``restore(shardings=)`` gather
    and slice each leaf by and what the trainer keeps each rank's shard
    by."""
    from repro_torch import tree
    from repro_torch.optim.adamw import Q8

    ctx = ctx or active()
    p_sh = param_shardings(state["params"], ctx)
    paths = [p for p, _ in tree.flatten_with_paths(state["params"])]

    def like_params(sub):
        it = iter(paths)

        def leaf(_sh, node):
            path = next(it)
            if isinstance(node, Q8):
                return Q8(LeafSharding(_sh.spec, _shape(node.q)),
                          LeafSharding(param_spec(path, node.scale, ctx), _shape(node.scale)))
            return LeafSharding(_sh.spec, _shape(node))
        return tree.tree_map(leaf, p_sh, sub)

    out = {"params": p_sh,
           "opt": {"step": LeafSharding((), ()),
                   "m": like_params(state["opt"]["m"]),
                   "v": like_params(state["opt"]["v"])}}
    if "ef" in state:
        out["ef"] = like_params(state["ef"])
    return out
