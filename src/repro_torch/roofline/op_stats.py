"""Per-step operation counts of the port, taken while the step runs on
``meta`` tensors: the counterpart of ``repro/roofline/hlo_stats.py``.

There is no HLO to parse: eager PyTorch dispatches each operation of
the step as it runs, so :func:`counting` runs the step under a
``TorchDispatchMode`` that sees every aten op, the remat recompute and
the backward included, and reads the port's own counters around it:

* ``dot_flops``, by dtype (``dot_flops_by_dtype``) — the products'
  operations, from ``torch.utils.flop_counter``'s formulas (mm, bmm,
  addmm, convolution, attention ...), the dtype the first operand's;
* ``hbm_bytes`` — every aten op's inputs plus outputs (a tensor's bytes,
  at most its storage's: a broadcast operand counts once), view ops and
  allocations without a write excluded.  Eager PyTorch launches each op
  as a kernel of its own (25,768 in one TinyLlama QAT step on the card),
  so nothing is fused away; the reference assumed XLA:TPU fusion and
  counted only memory-relevant ops;
* ``kernels`` and ``kernel_work`` — in place of the reference's
  ``vpu_ops``: the ``csrc/`` kernels the step would launch, recorded by
  their wrappers on ``meta`` operands (``kernels._build.record``: per
  launch key, the problem), and their operations by class and bytes
  (``analysis.kernel_work``); ``kernel_work`` bytes are added to
  ``hbm_bytes``;
* ``collectives`` — per kind, the bytes this rank sends (the training
  mesh's ``launch.mesh.collectives``, the serving mesh's
  ``parallel.qmm_mesh.collectives``), their counts, and, on a
  :class:`~repro_torch.launch.mesh.PlaceholderMesh`, the ordered
  schedule and the bytes per mesh axis;
* ``peak_live_bytes`` — the most bytes of tensor storage alive at once:
  the arguments' storages plus every storage an op created, until it is
  freed.

Not carried over from the reference: trip-count scaling (PyTorch runs
its Python loop over the periods, so every period is counted as it runs)
and the all-reduce to reduce-scatter reclassification (the port's
training mesh calls ``reduce_scatter_tensor`` itself).  Numbers are one
rank's, as the reference's are one device's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Dict, Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import tree
from repro_torch.roofline.analysis import DTYPE_CLASS, Work, kernel_work

__all__ = ["OpStats", "counting", "tree_tensors", "tree_bytes"]

_COLLECTIVE_KINDS = ("all_gather", "reduce_scatter", "all_reduce")
# allocations that launch no kernel
_NO_WRITE = frozenset({"empty", "empty_strided", "new_empty", "new_empty_strided",
                       "empty_like"})


def _tensors(x) -> Iterator[torch.Tensor]:
    """The tensors of an op's arguments or outputs (lists, tuples, dicts)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def tree_tensors(t: Any) -> List[torch.Tensor]:
    """Every tensor leaf of a tree of the port (``tree.flatten_with_paths``:
    dicts, lists, tuples, ``QTensor`` and ``Q8`` containers opened)."""
    return [x for _, x in tree.flatten_with_paths(t) if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's bytes, at most its storage's."""
    n = t.numel() * t.element_size()
    return min(n, t.untyped_storage().nbytes())


def tree_bytes(t: Any, exclude: Any = None) -> int:
    """Bytes of the distinct storages of the tensors of ``t``, but those
    that ``exclude``'s tensors also use."""
    seen = {x.untyped_storage()._cdata for x in tree_tensors(exclude)}
    total = 0
    for x in tree_tensors(t):
        s = x.untyped_storage()
        if s._cdata not in seen:
            seen.add(s._cdata)
            total += s.nbytes()
    return total


@dataclasses.dataclass
class OpStats:
    ops: int = 0
    dot_flops: float = 0.0
    dot_flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)
    hbm_bytes: float = 0.0
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_work: Work = dataclasses.field(default_factory=Work)
    collectives: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_ops: List[str] = dataclasses.field(default_factory=list)
    collective_bytes_by_axis: Dict[str, float] = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    peak_live_bytes: int = 0

    @property
    def ops_by_class(self) -> Dict[str, float]:
        """Operations by class of work: the float products by their
        dtype's class, then the kernels' (``analysis.HW.peak``'s keys)."""
        out: Dict[str, float] = {}
        for dt, f in self.dot_flops_by_dtype.items():
            cls = DTYPE_CLASS.get(dt, "f32")
            out[cls] = out.get(cls, 0.0) + f
        for cls, v in self.kernel_work.ops.items():
            out[cls] = out.get(cls, 0.0) + v
        return out

    def as_dict(self) -> Dict[str, Any]:
        return {
            "dot_flops": self.dot_flops,
            "dot_flops_by_dtype": dict(self.dot_flops_by_dtype),
            "hbm_bytes": self.hbm_bytes,
            "aten_ops": self.ops,
            "kernels": dict(self.kernels),
            "kernel_ops": dict(self.kernel_work.ops),
            "kernel_bytes": self.kernel_work.bytes,
            "ops_by_class": self.ops_by_class,
            "collectives": dict(self.collectives),
            "collective_bytes_by_axis": dict(self.collective_bytes_by_axis),
            "argument_bytes": self.argument_bytes,
            "peak_live_bytes": self.peak_live_bytes,
        }


class _Live:
    """Bytes of the storages alive now, and the most ever."""

    def __init__(self):
        self.sizes: Dict[int, int] = {}
        self.now = self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self.sizes:
            return
        n = s.nbytes()
        self.sizes[key] = n
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(s, self._drop, key)

    def _drop(self, key: int) -> None:
        self.now -= self.sizes.pop(key, 0)


class _Counting(TorchDispatchMode):
    def __init__(self, stats: OpStats, live: _Live):
        super().__init__()
        self.stats, self.live = stats, live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        st = self.stats
        st.ops += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            first = next(_tensors(args), None)
            dt = str(first.dtype).replace("torch.", "") if first is not None else "float32"
            st.dot_flops += flops
            st.dot_flops_by_dtype[dt] = st.dot_flops_by_dtype.get(dt, 0.0) + flops
        outs = list(_tensors(out))
        if not func.is_view and packet.__name__ not in _NO_WRITE:
            ins = list(_tensors((args, kwargs)))
            in_keys = {t.untyped_storage()._cdata for t in ins}
            writes = any(a.alias_info is not None and a.alias_info.is_write
                         for a in func._schema.arguments)
            # an op whose every output is an input's storage and that writes
            # none of them is a view in all but name (_unsafe_view, alias)
            if writes or not outs or any(o.untyped_storage()._cdata not in in_keys
                                         for o in outs):
                st.hbm_bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(o) for o in outs)
        for o in outs:
            self.live.add(o)
        return out


@contextlib.contextmanager
def counting(arguments: Any = None) -> Iterator[OpStats]:
    """Count what runs in the block (module docstring): every aten op on
    this thread and the threads autograd runs it on, the kernels recorded
    on ``meta`` and the collectives of either mesh.  ``arguments``: the
    tree of the step's inputs, whose storages are alive from the start
    (``argument_bytes``).  The kernel, collective and schedule counters
    are reset on entry."""
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel import qmm_mesh

    stats = OpStats()
    live = _Live()
    for t in tree_tensors(arguments):
        live.add(t)
    stats.argument_bytes = live.now
    _build.reset_records()
    mesh_mod.reset_collectives()
    qmm_mesh.reset_collectives()
    mesh_mod.reset_schedule()
    try:
        with _Counting(stats, live):
            yield stats
    finally:
        for key, problem in _build.records():
            stats.kernels[key] = stats.kernels.get(key, 0) + 1
            stats.kernel_work = stats.kernel_work + kernel_work(key, problem)
        stats.hbm_bytes += stats.kernel_work.bytes
        train, serve = mesh_mod.collectives(), qmm_mesh.collectives()
        coll: Dict[str, float] = {}
        for kind in _COLLECTIVE_KINDS:
            n = train.get(kind, 0) + serve.get(kind, 0)
            b = train.get(f"{kind}_bytes", 0) + serve.get(f"{kind}_bytes", 0)
            coll[kind.replace("_", "-")] = float(b)
            coll[f"{kind}_count"] = n
        for key, v in train.items():
            if "_bytes_" in key:
                coll[key] = float(v)
        coll["total"] = sum(coll[k.replace("_", "-")] for k in _COLLECTIVE_KINDS)
        stats.collectives = coll
        sched = mesh_mod.schedule()
        stats.collective_ops = [f"{kind} {axis} {dtype}{list(shape)}"
                                for kind, axis, dtype, shape, _ in sched]
        by_axis: Dict[str, float] = {}
        for _, axis, _, _, nbytes in sched:
            by_axis[axis] = by_axis.get(axis, 0.0) + nbytes
        stats.collective_bytes_by_axis = by_axis
        stats.peak_live_bytes = live.peak

