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
(:func:`param_spec`), so models carry no annotation tree;
:func:`payload_plane_axes` gives the (n, k-words) axes a packed QTensor
records as its ``pspec`` (models/packing.py), through the same table.

The serving mesh only.  Each rank of a mesh holds its own slice of the
packed bit planes (``parallel/qmm_mesh.py``); every float leaf (the
embedding, the LM head, the norms, the MoE router) is replicated on every
rank, and activations are replicated between projections.  So
:func:`constrain` and :func:`constrain_spec` are the identity here, and
:func:`param_shardings` returns the per-leaf specs without placing
anything.  Sharded float leaves and gradients belong to the training
mesh, a later slice of the port.
"""

from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = ["Rules", "TRAIN_RULES", "SERVE_RULES", "SERVE_RULES_MOE", "SERVE_RULES_LOWBIT",
           "PREFILL_RULES", "TRAIN_RULES_FSDP", "TRAIN_RULES_HYBRID", "SERVE_RULES_EP",
           "RULESETS", "use_mesh", "active", "spec_for", "constrain", "constrain_spec",
           "param_spec", "param_shardings", "payload_plane_axes"]

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
    """Sharding constraint by logical axes: the identity (activations are
    replicated on the serving mesh; module docstring)."""
    return x


def constrain_spec(x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """Sharding constraint by an explicit spec: the identity."""
    return x


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


def _match_rules(s: str, leaf, ndim: int, ctx) -> Optional[Spec]:
    shape = _shape(leaf)
    if ndim == 3:
        for pat, axes in _PARAM_RULES_3D:
            if re.search(pat, s):
                return spec_for(shape, axes, ctx)
    for pat, axes in _PARAM_RULES:
        if re.search(pat, s) and len(axes) == ndim:
            return spec_for(shape, axes, ctx)
    # period-stacked params carry a leading period dim
    if ndim >= 1 and re.search(r"blocks/", s):
        for pat, axes in (_PARAM_RULES_3D if ndim == 4 else ()):
            if re.search(pat, s):
                return (None,) + spec_for(shape[1:], axes, ctx)
        for pat, axes in _PARAM_RULES:
            if re.search(pat, s) and len(axes) == ndim - 1:
                return (None,) + spec_for(shape[1:], axes, ctx)
    return None


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
    """The tree of per-leaf specs matching ``params`` (containers opened,
    paths as ``tree.map_with_paths`` writes them).  Nothing is placed:
    on the serving mesh the packed planes are sliced when packed and the
    float leaves are replicated (module docstring)."""
    from repro_torch import tree

    ctx = ctx or active()
    assert ctx is not None, "param_shardings requires use_mesh()"
    return tree.map_with_paths(lambda path, leaf: param_spec(path, leaf, ctx), params)
