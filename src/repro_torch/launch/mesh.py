"""Device meshes over a ``torch.distributed`` world, and the helpers that
start and join the ranks.

Counterpart of ``repro/launch/mesh.py``.  The reference's mesh is a grid
of the devices of one JAX process; the port's is a grid of *ranks*: one
process per mesh position, each computing on its own ``torch.device``
(``cuda:(LOCAL_RANK % device_count)`` by default, or the CPU when the
caller asks).  Axes, as in the reference:

* "pod"   — pure data parallelism across pods;
* "data"  — FSDP weight sharding + batch within a pod;
* "model" — tensor parallelism.

A :class:`Mesh` holds one process group per axis *line* (the ranks that
differ only in that axis' coordinate): the integer all-reduce of a
k-sharded projection runs over the group along its k axis, the gather of
an n-sharded one over the group along its n axis
(``parallel/qmm_mesh.py``).  ``torch.distributed.new_group`` is
collective, so every rank of the world calls :func:`make_mesh` with the
same arguments, members of the new mesh or not (after an elastic rebuild
the ranks left out take part in the group creation, then leave).

The training mesh (``train/train_step.py``) adds collectives over one or
several axes: :meth:`Mesh.all_gather_axes` (a leaf's shards, whole, in a
spec entry's order; the sequence shards of a tensor-parallel step),
:meth:`Mesh.reduce_scatter_sum` (one ``reduce_scatter_tensor`` per axis,
in the operand's dtype: bf16 cotangents stay bf16, a row-parallel
projection's partial counts int32; gloo runs it on the host),
:meth:`Mesh.all_reduce_axes_` and :meth:`Mesh.all_reduce_`;
:func:`collectives` counts them with their bytes and host seconds.

Transport: NCCL when every rank has a card of its own, gloo otherwise
(several ranks sharing one card, or the CPU).  Gloo moves CPU tensors:
on a card the mesh stages each collective's operand through host memory
(``Mesh.comm_device``), so the kernels run on the card and only the
transport goes through the host.  The choice is printed once by
:func:`init_rank`; nothing falls back from one backend to the other.

:class:`PlaceholderMesh` is one rank's view of a mesh without a world
(the dry-run's counterpart of the reference's 512 forced host devices,
``launch/dryrun.py``): the axis names, shape and one rank's coordinates,
no process group; its collectives move nothing and return ``meta``
tensors of the right shape, counted as a real mesh counts them, and it
keeps the ordered schedule of every transport call (:func:`schedule`).
``make_production_mesh(placeholder=True)`` builds the (16, 16) pod and
the (2, 16, 16) multi-pod from it.

Rank plumbing (tests, ``chip_smoke.py``, ``launch/serve.py``):
:func:`run_ranks` starts ``world_size`` processes of one command with
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` and a fresh file-store
rendezvous, waits with a hard timeout and kills what overruns;
:func:`init_rank` joins the world from those variables (or from
``torchrun``'s), with a 60 s collective timeout, and
:func:`shutdown` leaves it.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import os
import shutil
import signal
import subprocess
import tempfile
import time
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "PlaceholderMesh", "MeshDesyncError", "collectives", "reset_collectives",
           "schedule", "reset_schedule", "POD_SHAPE", "make_mesh", "make_host_mesh",
           "make_serve_mesh", "make_production_mesh", "pick_backend", "init_rank",
           "shutdown", "run_ranks", "rank_logs", "STORE_ENV", "DEFAULT_TIMEOUT_S"]

POD_SHAPE = (16, 16)   # 256 chips per pod

# The file-store rendezvous path run_ranks hands each rank.
STORE_ENV = "REPRO_MESH_STORE"
DEFAULT_TIMEOUT_S = 60.0


# The training mesh's collectives (Mesh.all_gather_axes, reduce_scatter_sum,
# all_reduce_axes_, all_reduce_): count, operand bytes and host seconds per
# kind, and bytes per kind and dtype.
_COLLECTIVES: collections.Counter = collections.Counter()


def collectives() -> Dict[str, float]:
    """The training mesh's collectives since :func:`reset_collectives`:
    ``<kind>`` (one per axis a collective runs over), ``<kind>_bytes`` (the
    operand this rank sends: its shard for a gather, the whole tensor for a
    reduce-scatter or an all-reduce), ``<kind>_bytes_<dtype>`` and
    ``<kind>_s`` (host seconds, staging included), for the kinds
    ``all_gather``, ``reduce_scatter`` and ``all_reduce``."""
    return dict(_COLLECTIVES)


def reset_collectives() -> None:
    _COLLECTIVES.clear()


# A PlaceholderMesh's transport calls in order: (kind, axis or "all",
# dtype, shape, bytes this rank sends).
_SCHEDULE: List[tuple] = []


def schedule() -> List[tuple]:
    """Every collective a :class:`PlaceholderMesh` ran since
    :func:`reset_schedule`, in order: ``(kind, axis, dtype, shape,
    bytes)``, the bytes the operand this rank sends (its shard for a
    gather)."""
    return list(_SCHEDULE)


def reset_schedule() -> None:
    _SCHEDULE.clear()


@contextlib.contextmanager
def _counted(kind: str, t: torch.Tensor):
    nbytes = t.numel() * t.element_size()
    _COLLECTIVES[kind] += 1
    _COLLECTIVES[f"{kind}_bytes"] += nbytes
    _COLLECTIVES[f"{kind}_bytes_{str(t.dtype).replace('torch.', '')}"] += nbytes
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _COLLECTIVES[f"{kind}_s"] += time.perf_counter() - t0


class MeshDesyncError(RuntimeError):
    """Ranks of one mesh disagree on a value they must share (the
    scheduler's per-tick state digest): their collectives would pair up
    wrongly, so the mesh stops."""


def pick_backend(device: torch.device, local_world_size: int) -> str:
    """NCCL when ``device`` is a card and every rank can have one of its
    own: ``local_world_size``, the ranks on this host, at most the cards
    this host sees.  Else gloo."""
    if device.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


class Mesh:
    """An ``axis_names``-named grid of ``shape`` over global ranks.

    ``devices`` is the grid of global ranks (the reference's
    ``mesh.devices``, whose entries are devices); ``rank`` this process'
    global rank, ``coords`` its coordinate on each axis (empty when it is
    not a member), ``device`` the ``torch.device`` it computes on and
    ``groups[axis]`` the process group of its line along ``axis``."""

    def __init__(self, shape, axis_names, ranks, device: torch.device,
                 backend: Optional[str], groups: Dict[str, object], group):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.devices = np.asarray(ranks, dtype=np.int64).reshape(self.shape)
        self.device = device
        self.backend = backend
        self.groups = groups
        self.group = group
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        where = np.argwhere(self.devices == self.rank)
        self.member = len(where) == 1
        self.coords = ({ax: int(i) for ax, i in zip(self.axis_names, where[0])}
                       if self.member else {})

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def comm_device(self) -> torch.device:
        """Where collective operands live: the card under NCCL, the host
        under gloo (or without a process group)."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[axis]

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, ranks="
                f"{self.devices.reshape(-1).tolist()}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")

    # -- collectives --------------------------------------------------------

    def _group(self, axis: Optional[str]):
        return self.group if axis is None else self.groups[axis]

    # the transport: torch.distributed on a real mesh (PlaceholderMesh
    # moves nothing)
    def _all_reduce(self, buf: torch.Tensor, op, group) -> None:
        dist.all_reduce(buf, op=op, group=group)

    def _all_gather(self, parts: List[torch.Tensor], src: torch.Tensor, group) -> None:
        dist.all_gather(parts, src, group=group)

    def _reduce_scatter(self, out: torch.Tensor, src: torch.Tensor, group) -> None:
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)

    def all_reduce_sum_(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``t`` over the line along ``axis``; the result lands in a
        tensor on ``t``'s device (``t`` itself when no staging is
        needed)."""
        if self.axis_size(axis) == 1:
            return t
        buf = t.to(self.comm_device)
        self._all_reduce(buf, dist.ReduceOp.SUM, self._group(axis))
        return buf.to(t.device)

    def all_gather_cat(self, t: torch.Tensor, axis: str, dim: int = -1) -> torch.Tensor:
        """The slices of the line along ``axis`` concatenated on ``dim`` in
        coordinate order: an exact copy, no arithmetic."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        src = t.contiguous().to(self.comm_device)
        parts = [torch.empty_like(src) for _ in range(n)]
        self._all_gather(parts, src, self._group(axis))
        return torch.cat(parts, dim=dim).to(t.device)

    def all_gather_axes(self, t: torch.Tensor, axes: Sequence[str], dim: int) -> torch.Tensor:
        """The slices of ``t`` over the sub-grid of ``axes`` concatenated on
        ``dim`` in a spec entry's order: chunk ``i`` of ``dim`` is the rank
        whose coordinates on ``axes`` (first axis major) number ``i``.  An
        exact copy; the innermost axis is gathered first."""
        for ax in reversed(tuple(axes)):
            if self.axis_size(ax) > 1:
                with _counted("all_gather", t):
                    t = self.all_gather_cat(t, ax, dim=dim)
        return t

    def reduce_scatter_sum(self, t: torch.Tensor, axes: Sequence[str],
                           dim: int) -> torch.Tensor:
        """Sum ``t`` over the sub-grid of ``axes`` and keep this rank's chunk
        of ``dim`` (the inverse layout of :meth:`all_gather_axes`): one
        ``reduce_scatter_tensor`` per axis, outermost first, in ``t``'s
        dtype (bf16 sums in bf16, as the wire carries it)."""
        for ax in tuple(axes):
            n = self.axis_size(ax)
            if n == 1:
                continue
            with _counted("reduce_scatter", t):
                src = t.movedim(dim, 0).contiguous().to(self.comm_device)
                out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                                  dtype=src.dtype, device=src.device)
                self._reduce_scatter(out, src, self._group(ax))
                t = out.movedim(0, dim).to(t.device)
        return t

    def all_reduce_axes_(self, t: torch.Tensor, axes: Sequence[str],
                         op: str = "sum") -> torch.Tensor:
        """All-reduce ``t`` ("sum", "max" or "min") over the sub-grid of
        ``axes``, one axis after the other; the result on ``t``'s device."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        axes = [ax for ax in axes if self.axis_size(ax) > 1]
        if not axes:
            return t
        buf = t.to(self.comm_device)
        for ax in axes:
            with _counted("all_reduce", t):
                self._all_reduce(buf, red, self._group(ax))
        return buf.to(t.device)

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """All-reduce ``t`` over every member of the mesh (one collective)."""
        if self.group is None or self.size == 1:
            return t
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        with _counted("all_reduce", t):
            buf = t.to(self.comm_device)
            self._all_reduce(buf, red, self.group)
        return buf.to(t.device)

    def barrier(self) -> None:
        """Every member waits for the others (an all-reduce of one
        integer, which NCCL and gloo both run on ``comm_device``)."""
        if self.group is None or self.size == 1:
            return
        dist.all_reduce(torch.zeros(1, dtype=torch.int32, device=self.comm_device),
                        group=self.group)

    def gather_values(self, value: float) -> List[float]:
        """Every member's ``value``, in mesh order (one all-gather)."""
        if self.group is None or self.size == 1:
            return [float(value)]
        t = torch.tensor([value], dtype=torch.float64, device=self.comm_device)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return [float(p.item()) for p in parts]

    def agree(self, values: Sequence[int], what: str) -> None:
        """Raise :class:`MeshDesyncError` unless every member holds the
        same integer ``values`` (one all-reduce of a CRC of them)."""
        if self.group is None or self.size == 1:
            return
        d = zlib.crc32(np.asarray(values, dtype=np.int64).tobytes())
        t = torch.tensor([d, -d], dtype=torch.int64, device=self.comm_device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        hi, neg_lo = t.tolist()
        if hi != -neg_lo:
            raise MeshDesyncError(f"ranks of {self!r} disagree on {what}")

    def from_first(self, value: float) -> float:
        """The first member's ``value`` on every member (a broadcast): the
        clock readings the scheduler acts on."""
        if self.group is None or self.size == 1:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=self.comm_device)
        dist.broadcast(t, src=int(self.devices.reshape(-1)[0]), group=self.group)
        return float(t.item())


class PlaceholderMesh(Mesh):
    """One rank's view of a ``shape`` mesh of ``axis_names`` with no world
    behind it (module docstring): rank 0 of the grid, computing on
    ``meta``.  Collectives run the real mesh's code, counted
    by :func:`collectives` (and ``qmm_mesh.collectives``) as there; the
    transport moves nothing (every operand is a ``meta`` tensor, whose
    result shape the real mesh's code already gives) and appends each
    call to :func:`schedule`.  Agreement and clock reads return this
    rank's own values.  ``sharding.use_mesh``, ``qmm_sharded`` and the
    train step take it as a real mesh."""

    def __init__(self, shape, axis_names):
        n = int(np.prod(shape))
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.devices = np.arange(n, dtype=np.int64).reshape(self.shape)
        self.device = torch.device("meta")
        self.backend = "placeholder"
        self.rank = 0
        self.member = True
        self.coords = {ax: 0 for ax in self.axis_names}
        # a group per axis line this rank is on, named by its axis
        self.groups = {ax: ax for ax in self.axis_names}
        self.group = "all"

    @property
    def comm_device(self) -> torch.device:
        return self.device

    def _all_reduce(self, buf, op, group) -> None:
        _SCHEDULE.append(("all_reduce", group, _dtype(buf), tuple(buf.shape), _bytes(buf)))

    def _all_gather(self, parts, src, group) -> None:
        _SCHEDULE.append(("all_gather", group, _dtype(src), tuple(src.shape), _bytes(src)))

    def _reduce_scatter(self, out, src, group) -> None:
        _SCHEDULE.append(("reduce_scatter", group, _dtype(src), tuple(src.shape),
                          _bytes(src)))

    def barrier(self) -> None:
        return None

    def gather_values(self, value: float) -> List[float]:
        return [float(value)] * self.size

    def agree(self, values: Sequence[int], what: str) -> None:
        return None

    def from_first(self, value: float) -> float:
        return value

    def __repr__(self) -> str:
        return (f"PlaceholderMesh({dict(zip(self.axis_names, self.shape))}, "
                "rank=0, device=meta)")


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _default_device() -> torch.device:
    """This rank's card: ``LOCAL_RANK % device_count``."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if torch.cuda.is_available():
        return torch.device("cuda", local % torch.cuda.device_count())
    raise RuntimeError("no CUDA device: pass device='cpu' to run the mesh on the CPU")


# The collective timeout of the world init_rank joined, which every group
# of a mesh shares (``new_group`` would otherwise take the backend's
# default of many minutes).
_TIMEOUT_S = DEFAULT_TIMEOUT_S


def _new_group(ranks: List[int], backend: Optional[str]):
    return dist.new_group(sorted(ranks), backend=backend,
                          timeout=datetime.timedelta(seconds=_TIMEOUT_S))


def make_mesh(shape, axes, ranks: Optional[Sequence[int]] = None,
              device: Optional[torch.device] = None) -> Mesh:
    """Build a mesh of ``shape`` over ``ranks`` (default: every rank of
    the world, in order), computing on ``device`` (default: the card
    ``LOCAL_RANK % device_count``, as :func:`init_rank` picks it).

    Collective: every rank of the world calls it with the same arguments.
    An explicit rank list is how the elastic path rebuilds on the
    survivors; ranks not in it get a mesh they are not a member of."""
    n = int(np.prod(shape))
    if dist.is_initialized():
        world = dist.get_world_size()
        backend = dist.get_backend()
    else:
        world, backend = 1, None
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) < n:
        raise RuntimeError(
            f"need {n} devices for mesh {tuple(shape)}, have {len(ranks)} — start one "
            f"process per device (torchrun --nproc-per-node, or launch.mesh.run_ranks)")
    ranks = sorted(ranks[:n])
    device = device if device is not None else _default_device()
    grid = np.asarray(ranks, dtype=np.int64).reshape(tuple(shape))
    if backend is None:
        if n != 1:
            raise RuntimeError(f"a {tuple(shape)} mesh needs torch.distributed "
                               f"initialized (launch.mesh.init_rank)")
        return Mesh(shape, axes, ranks, device, None, {ax: None for ax in axes}, None)
    me = dist.get_rank()
    groups: Dict[str, object] = {}
    # every rank creates every group, in one order
    group = _new_group(ranks, backend)
    for i, ax in enumerate(axes):
        lines = np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i])
        for line in lines:
            g = _new_group(line.tolist(), backend)
            if me in line:
                groups[ax] = g
    return Mesh(shape, axes, ranks, device, backend, groups, group)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[torch.device] = None,
                         placeholder: bool = False) -> Mesh:
    """The (16, 16) ("data", "model") pod, or with ``multi_pod`` the (2,
    16, 16) ("pod", "data", "model") multi-pod: over the world's ranks,
    or with ``placeholder`` as rank 0's :class:`PlaceholderMesh` (no
    world; the dry-run)."""
    shape = (2,) + POD_SHAPE if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if placeholder:
        return PlaceholderMesh(shape, axes)
    return make_mesh(shape, axes, device=device)


def make_host_mesh(device: Optional[torch.device] = None) -> Mesh:
    """Every rank of the world as a (1, N) ("data", "model") mesh."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((1, n), ("data", "model"), device=device)


def make_serve_mesh(model: Optional[int] = None, data: int = 1,
                    ranks: Optional[Sequence[int]] = None,
                    device: Optional[torch.device] = None) -> Mesh:
    """(data, model) mesh for the low-bit serving engine
    (``ServeConfig(mesh=...)``); ``model`` defaults to whatever fills the
    ranks."""
    if ranks is None:
        ranks = list(range(dist.get_world_size() if dist.is_initialized() else 1))
    if model is None:
        model = len(ranks) // data
    return make_mesh((data, model), ("data", "model"), ranks=ranks, device=device)


# ---------------------------------------------------------------------------
# Starting and joining ranks
# ---------------------------------------------------------------------------

def _local_world_size() -> int:
    """The ranks on this host: ``LOCAL_WORLD_SIZE`` (``torchrun`` and
    :func:`run_ranks` set it), else ``WORLD_SIZE`` (a one-host world)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))


def init_rank(device: Optional[str] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the world this process was started in: ``RANK`` /
    ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` and either
    :data:`STORE_ENV` (a file-store path, :func:`run_ranks`) or
    ``torchrun``'s ``MASTER_ADDR`` / ``MASTER_PORT``.  ``device``: "cpu", "cuda" or
    None (the card ``LOCAL_RANK % device_count``).  Picks the backend
    (:func:`pick_backend`), prints it with the rank count, and returns
    the device this rank computes on (pass it to :func:`make_mesh`)."""
    global _TIMEOUT_S
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    _TIMEOUT_S = timeout_s
    if device is None or device == "cuda":
        dev = _default_device()
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    backend = pick_backend(dev, _local_world_size())
    store = os.environ.get(STORE_ENV)
    init = f"file://{store}" if store else "env://"
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        print(f"[mesh] backend {backend}: {world} ranks on {dev.type}"
              + (f" ({torch.cuda.device_count()} card(s))" if dev.type == "cuda" else ""),
              flush=True)
    return dev


def shutdown() -> None:
    """Leave the world (``destroy_process_group``), if joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(argv: Sequence[str], world_size: int, *, timeout_s: float,
              env: Optional[Dict[str, str]] = None, log_dir: Optional[str] = None,
              cwd: Optional[str] = None) -> List[Dict[str, object]]:
    """Run ``argv`` as ``world_size`` processes (ranks 0..N-1) that meet
    at a fresh file-store rendezvous; wait at most ``timeout_s`` seconds
    for all of them, then kill every one still running.  Each rank's
    output goes to ``<log_dir>/rank<r>.log``.  Returns per rank
    ``{"rank", "returncode" (None if it was killed), "log"}``."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="repro_mesh_")
    os.makedirs(log_dir, exist_ok=True)
    rdzv = tempfile.mkdtemp(prefix="repro_rdzv_")
    store = os.path.join(rdzv, "store")
    procs = []
    for r in range(world_size):
        e = dict(os.environ if env is None else env)
        e.update({"RANK": str(r), "WORLD_SIZE": str(world_size), "LOCAL_RANK": str(r),
                  "LOCAL_WORLD_SIZE": str(world_size), STORE_ENV: store})
        log = os.path.join(log_dir, f"rank{r}.log")
        with open(log, "w") as f:
            p = subprocess.Popen(list(argv), env=e, cwd=cwd, stdout=f,
                                 stderr=subprocess.STDOUT, start_new_session=True)
        procs.append((r, p, log))
    deadline = time.monotonic() + timeout_s
    out = []
    for r, p, log in procs:
        try:
            rc = p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = None
        out.append({"rank": r, "returncode": rc, "log": log})
    for (r, p, _), res in zip(procs, out):
        if res["returncode"] is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
    shutil.rmtree(rdzv, ignore_errors=True)
    return out


def rank_logs(results: Sequence[Dict[str, object]], tail: int = 4000) -> str:
    """The end of each rank's log, for an error message."""
    parts = []
    for res in results:
        with open(res["log"]) as f:
            text = f.read()
        parts.append(f"--- rank {res['rank']} (exit {res['returncode']}) ---\n{text[-tail:]}")
    return "\n".join(parts)
