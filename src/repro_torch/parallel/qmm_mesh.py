"""Mesh-aware low-bit matmul: shard the packed bit-plane words, all-reduce
integers.

Counterpart of ``repro/parallel/qmm_mesh.py``: the paper's
accumulate-in-integer design lifted across devices.  A QTensor packed
under an active mesh records the mesh axes of its payload planes' (n,
k-words) dims (``QTensor.pspec``, models/packing.py) and each rank keeps
only its slice of them (:func:`take_local`).  When ``ops.qmm`` runs inside
``sharding.use_mesh`` it dispatches such a container here, on every rank
of the mesh (SPMD over ``torch.distributed``):

* activations enter every rank **replicated**, so the per-tensor
  quantization statistics and the packed activation planes are the same
  on every rank;
* **n-sharded** planes (column-parallel: wq/wk/wv/gate/up) run the fused
  kernel on their output slice; the slices are gathered along the n axis
  into the replicated output, an exact copy with no arithmetic;
* **k-sharded** planes (row-parallel: wo/down, and the "data" axis of
  ``SERVE_RULES_LOWBIT``) take their contiguous word range of the
  activation planes, run the *unfused* int32 popcount core with
  ``k_valid=0`` (BNN then gives ``-2 * popcount``), and all-reduce the
  int32 partial counts over the k axis; BNN's ``+ k`` and the eq. (2)
  epilogue ``acc * row * col (+ bias)`` are applied once, after the sum.
  No float output is ever summed across ranks.  The same k-sharded
  matmul (:func:`k_sharded_matmul`) runs the training mesh's
  row-parallel projections (``ops.quantized_matmul``), whose weights are
  packed in the step and whose int32 counts are reduce-scattered into
  sequence shards under sequence parallelism.

Integer addition is associative and zero pad words contribute zero in
every encoding, so the outputs are bit-identical to the single-device
``qmm``.  ``ShardPlan.acc_dtype`` keeps the reference's
:func:`~repro_torch.kernels._matmul_common.psum_accum_dtype` (the bound
on the partials); the wire carries int32, because neither gloo nor NCCL
sums 16-bit integers, and ``repro_mesh_psum_wire_bytes_total`` counts the
bytes actually moved (``m * n_local * 4`` per reduction).

:func:`collectives` counts the all-reduces and gathers this process
issued, their bytes and the host seconds spent in them (staging
included, and the wait for the slowest rank), as
``kernels._build.launches`` counts kernel launches.  The reference's
trace counter ``qmm_mesh_trace_count`` has no counterpart: nothing
traces in PyTorch.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels._matmul_common import psum_accum_dtype, scale_epilogue
from repro_torch.kernels.modes import QuantMode
from repro_torch.kernels.qtensor import PAYLOAD_KEYS, POS_PAYLOAD_KEYS, QTensor
from repro_torch.parallel import sharding

__all__ = ["ShardPlan", "shard_plan", "shard_plan_conv", "local_dims", "take_local",
           "qmm_sharded", "k_sharded_matmul", "k_sharded_partial", "k_sharded_finish",
           "qconv_sharded", "collectives",
           "reset_collectives"]

_PSUM_CTR = obs.get_registry().counter(
    "repro_mesh_psum_total",
    "integer psum reductions issued by qmm_sharded",
    labels=("mode", "acc_dtype"))
_PSUM_BYTES_CTR = obs.get_registry().counter(
    "repro_mesh_psum_wire_bytes_total",
    "bytes moved per device by qmm_sharded psum reductions",
    labels=("mode",))

# The dtype the all-reduce moves (module docstring).
WIRE_DTYPE = torch.int32

_COLLECTIVES: collections.Counter = collections.Counter()


def collectives() -> Dict[str, int]:
    """All-reduces and gathers issued by this process since the last
    :func:`reset_collectives`, their bytes and host seconds:
    ``all_reduce``, ``all_reduce_bytes``, ``all_reduce_s``, and the
    same for ``all_gather``."""
    return dict(_COLLECTIVES)


def reset_collectives() -> None:
    _COLLECTIVES.clear()


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """How one QTensor's planes split over the active mesh: ``n_axis`` /
    ``k_axis`` are mesh axis names (or None) of the planes' output and
    k-word dims; ``acc_dtype`` the reference's partial-sum type."""
    n_axis: Optional[str] = None
    k_axis: Optional[str] = None
    n_shards: int = 1
    k_shards: int = 1
    acc_dtype: str = "int32"


def _live_axis(ctx, ax, dim: int) -> Tuple[Optional[str], int]:
    """A recorded axis, if it is live on the active mesh: it exists, has
    size > 1 and divides ``dim``."""
    if not isinstance(ax, str):
        return None, 1
    size = ctx.axis_sizes.get(ax)
    if not size or size <= 1 or dim % size != 0:
        return None, 1
    return ax, int(size)


def _global_dims(qt: QTensor) -> Tuple[int, int]:
    """The planes' global (n, kw) (n = cout for a conv container): the
    container may hold one rank's slice, its logical shape is global."""
    return qt.out_features, -(-qt.k_valid // 32)


def shard_plan(qt: QTensor, ctx=None) -> Optional[ShardPlan]:
    """Resolve the QTensor's recorded ``pspec`` against the active mesh;
    None (single-device dispatch) without a mesh, an annotation or a live
    axis."""
    ctx = ctx or sharding.active()
    if ctx is None or qt.pspec is None or not qt.is_lowbit:
        return None
    n, kw = _global_dims(qt)
    n_ax, ns = _live_axis(ctx, qt.pspec[0], n)
    k_ax, ks = _live_axis(ctx, qt.pspec[1], kw)
    if n_ax is None and k_ax is None:
        return None
    acc = psum_accum_dtype(kw * 32)
    return ShardPlan(n_axis=n_ax, k_axis=k_ax, n_shards=ns, k_shards=ks,
                     acc_dtype=str(acc).replace("torch.", ""))


def shard_plan_conv(qt: QTensor, ctx=None) -> Optional[ShardPlan]:
    """Conv variant: output-channel (cout) sharding only — the implicit
    im2col kernels gather patches along k, which does not word-slice."""
    ctx = ctx or sharding.active()
    if ctx is None or qt.pspec is None or not qt.is_lowbit or qt.geometry is None:
        return None
    n_ax, ns = _live_axis(ctx, qt.pspec[0], int(qt.geometry[3]))
    if n_ax is None:
        return None
    return ShardPlan(n_axis=n_ax, n_shards=ns)


def local_dims(qt: QTensor, ctx=None) -> Optional[Tuple[int, int]]:
    """Per-shard (n_local, k_local) of a sharded container: the problem
    the kernels of each rank see, and so what the plan cache answers for."""
    plan = shard_plan(qt, ctx)
    if plan is None:
        return None
    _, kw = _global_dims(qt)
    n_local = qt.out_features // plan.n_shards
    k_local = (kw // plan.k_shards) * 32 if plan.k_axis else qt.k_valid
    return (n_local, int(k_local))


def _plan_for(qt: QTensor, ctx) -> Optional[ShardPlan]:
    return shard_plan_conv(qt, ctx) if qt.geometry is not None else shard_plan(qt, ctx)


def _own(t: torch.Tensor) -> torch.Tensor:
    """A slice as a tensor of its own (no view keeping the whole alive)."""
    return t.clone() if t.is_contiguous() else t.contiguous()


def take_local(qt: QTensor, ctx=None) -> QTensor:
    """This rank's slice of a container annotated with a ``pspec``: the
    planes' n range (coordinate on the n axis) and k-word range
    (coordinate on the k axis), the scale's and bias' n range.  A
    container with no live axis comes back as it is."""
    ctx = ctx or sharding.active()
    plan = None if ctx is None else _plan_for(qt, ctx)
    if plan is None:
        return qt
    mesh = ctx.mesh
    n, kw = _global_dims(qt)
    nl, kwl = n // plan.n_shards, kw // plan.k_shards
    n0 = mesh.axis_index(plan.n_axis) * nl if plan.n_axis else 0
    w0 = mesh.axis_index(plan.k_axis) * kwl if plan.k_axis else 0
    known = set(PAYLOAD_KEYS[qt.mode]) | set(POS_PAYLOAD_KEYS.get(qt.mode, ()))
    extra = sorted(set(qt.payload) - known)
    if extra:
        raise ValueError(f"cannot shard payload keys {extra} (the mesh path runs the "
                         f"bit-plane kernels only)")
    payload = {}
    for key, p in qt.payload.items():
        p = p[..., n0:n0 + nl, :]
        if plan.k_axis:
            p = p[..., w0:w0 + kwl]
        payload[key] = _own(p)

    def cols(t):
        if t is None or t.ndim == 0:
            return t
        return _own(t[..., n0:n0 + nl])

    return qt.replace(payload=payload, scale=cols(qt.scale), bias=cols(qt.bias))


def _check_local(qt: QTensor, planes, n_local: int, kw_local: int) -> None:
    got = tuple(planes[0].shape[-2:])
    if got != (n_local, kw_local):
        raise ValueError(
            f"{qt!r} holds planes of {got}, not this mesh's ({n_local}, {kw_local}) "
            f"slice: pack it under the mesh it runs on (models/packing.py, take_local)")


def check_whole(qt: QTensor) -> None:
    """Raise when ``qt`` holds one rank's slice (dispatch outside its
    mesh would read it as the whole matrix)."""
    if qt.pspec is None or not qt.is_lowbit:
        return
    plane = qt.payload[PAYLOAD_KEYS[qt.mode][0]]
    n, kw = _global_dims(qt)
    if tuple(plane.shape[-2:]) != (n, kw):
        raise ValueError(f"{qt!r} holds one rank's slice {tuple(plane.shape[-2:])} of "
                         f"({n}, {kw}): run it inside its mesh (sharding.use_mesh)")


def _dense_partial(mode: QuantMode, a_loc, b_loc, bit0: int, k: int) -> torch.Tensor:
    """Signed integer partial for the dense backend (the reference computes
    it with ``jnp.dot`` outside Pallas): the local word range unpacked to
    +-1/0, the columns past the logical depth zeroed (binary pad bits
    decode to +1), one exact float32 product."""
    from repro_torch.core import encoding
    from repro_torch.core.conv import matmul_f32

    kb = int(a_loc[0].shape[1]) * 32
    if mode == QuantMode.BNN:
        av = encoding.unpack_binary(a_loc[0], kb)
    else:
        av = encoding.unpack_ternary(a_loc[0], a_loc[1], kb)
    if mode == QuantMode.TNN:
        bv = encoding.unpack_ternary(b_loc[0], b_loc[1], kb)
    else:
        bv = encoding.unpack_binary(b_loc[0], kb)
    mask = (bit0 + torch.arange(kb, device=av.device)) < k
    av = av * mask.to(av.dtype)[None, :]
    return matmul_f32(av, bv.t()).to(torch.int32)


def qmm_sharded(x: torch.Tensor, qt: QTensor, plan: ShardPlan, mesh, *,
                backend: str, act_stats: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Mesh-aware qmm (``ops.qmm`` calls it once a plan resolved): float
    ``x`` (m, k), replicated, against this rank's slice ``qt`` -> the
    replicated float32 (m, n) output (module docstring)."""
    from repro_torch.kernels import ops, registry

    mode = qt.mode
    m, k = int(x.shape[0]), int(x.shape[1])
    n, kw = _global_dims(qt)
    n_local, kw_local = n // plan.n_shards, kw // plan.k_shards
    planes = ops._b_planes(qt, mode)
    _check_local(qt, planes, n_local, kw_local)
    fused = plan.k_axis is None
    spec = registry.lookup(mode, backend, fused=fused)
    if spec.payload_aware:
        raise ValueError(f"backend {backend!r} reads whole payloads; the mesh path runs "
                         f"the bit-plane kernels (cuda, torch, dense)")
    k_local = kw_local * 32 if plan.k_axis else k
    tiles = ops._plan_tiles(spec, mode, backend, m, n_local, k_local, x.device, fused=fused)
    xa = ops.quantize_activations(x.to(torch.float32), mode, stats=act_stats)
    row = ops._as_row_scale(xa["scale"], m, x)
    col = ops._as_col_vec(qt.scale, n_local, x)
    b2 = None if qt.bias is None else ops._as_col_vec(qt.bias, n_local, x)
    a_pl = tuple(xa[key] for key in ops._A_KEYS[mode])
    if plan.k_axis is None:
        # column-parallel only: the fused kernel on this n slice
        out = spec.fn(a_pl, planes, k, row, col, b2, tiles=tiles)
    else:
        # row-parallel: this rank's word range of the replicated
        # activation planes (contiguous, as the kernels read rows) against
        # its resident weight words
        w0 = mesh.axis_index(plan.k_axis) * kw_local
        a_loc = tuple(p[:, w0:w0 + kw_local].contiguous() for p in a_pl)

        def psum(part):
            # the cross-rank reduction moves integer partial counts
            nbytes = part.numel() * part.element_size()
            _PSUM_CTR.inc(mode=mode.value, acc_dtype=str(WIRE_DTYPE).replace("torch.", ""))
            _PSUM_BYTES_CTR.inc(nbytes, mode=mode.value)
            _COLLECTIVES["all_reduce"] += 1
            _COLLECTIVES["all_reduce_bytes"] += nbytes
            t0 = time.perf_counter()
            acc = mesh.all_reduce_sum_(part, plan.k_axis)
            _COLLECTIVES["all_reduce_s"] += time.perf_counter() - t0
            return acc

        out = k_sharded_matmul(a_loc, planes, mode=mode, backend=backend, spec=spec,
                               tiles=tiles, bit0=w0 * 32, depth=k, k=k, reduce=psum,
                               row=row, col=col, bias=b2)
    return _gather(out, mesh, plan.n_axis)


def k_sharded_partial(a_loc, planes, *, mode: QuantMode, backend: str, spec, tiles,
                      bit0: int, depth: int) -> torch.Tensor:
    """One rank's int32 partial counts of a k-sharded (row-parallel) low-bit
    matmul: the int32 core of its activation words ``a_loc`` against its
    weight words ``planes`` (the unfused kernel with ``k_valid=0``: BNN then
    gives ``-2 * popcount``; on the dense backend a signed dot over the bits
    ``bit0 .. depth`` of the whole depth), in :data:`WIRE_DTYPE`.  INT8 /
    INT4: ``a_loc`` and ``planes`` are the (grid, zero point) pairs of the
    rank's k slice on the whole tensors' grids, and the partial is the
    eq. (3) core of the slice, ``k_valid`` its depth: the zero points are
    the global ones, so the ranks' partials sum to one device's core
    exactly (each within ``k * 255**2`` of 0: int32 holds it)."""
    if mode in (QuantMode.INT8, QuantMode.INT4):
        return spec.fn(a_loc, planes, int(a_loc[0].shape[1]), tiles=tiles).to(WIRE_DTYPE)
    if backend == "dense":
        return _dense_partial(mode, a_loc, planes, bit0, depth).to(WIRE_DTYPE)
    return spec.fn(a_loc, planes, 0, tiles=tiles).to(WIRE_DTYPE)


def k_sharded_finish(acc: torch.Tensor, *, mode: QuantMode, backend: str, k: int, row, col,
                     bias) -> torch.Tensor:
    """The reduced counts ``acc`` of :func:`k_sharded_partial` -> the float
    output: BNN's ``+ k`` (not on the dense backend, whose dot is signed)
    and the eq. (2) epilogue, once, after the sum (the affine cores need
    nothing more)."""
    if mode == QuantMode.BNN and backend != "dense":
        acc = k + acc
    return scale_epilogue(acc, row, col, bias)


def k_sharded_matmul(a_loc, planes, *, mode: QuantMode, backend: str, spec, tiles,
                     bit0: int, depth: int, k: int, reduce, row, col, bias) -> torch.Tensor:
    """The k-sharded (row-parallel) low-bit matmul of one rank:
    :func:`k_sharded_partial`, the partial counts reduced by ``reduce`` (an
    all-reduce over the k axis here; a reduce-scatter of the sequence under
    the training mesh's sequence parallelism, ``ops.quantized_matmul``),
    then :func:`k_sharded_finish`.  No float output is summed across
    ranks."""
    part = k_sharded_partial(a_loc, planes, mode=mode, backend=backend, spec=spec, tiles=tiles,
                             bit0=bit0, depth=depth)
    return k_sharded_finish(reduce(part), mode=mode, backend=backend, k=k, row=row, col=col,
                            bias=bias)


def _gather(out: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    if axis is None:
        return out
    _COLLECTIVES["all_gather"] += 1
    _COLLECTIVES["all_gather_bytes"] += out.numel() * out.element_size()
    t0 = time.perf_counter()
    out = mesh.all_gather_cat(out, axis, dim=-1)
    _COLLECTIVES["all_gather_s"] += time.perf_counter() - t0
    return out


def qconv_sharded(x: torch.Tensor, qt: QTensor, plan: ShardPlan, mesh,
                  act_stats: Dict[str, torch.Tensor], *, backend: str, stride: int,
                  padding: str) -> torch.Tensor:
    """Mesh-aware qconv: the implicit-im2col kernel on this rank's cout
    slice (the geometry shrinks to cout_local) with the shared activation
    statistics of the replicated input, the slices gathered over cout."""
    from repro_torch.kernels import conv_fused, ops, registry

    kh, kw_, cin, cout = qt.geometry
    cout_l = cout // plan.n_shards
    local = qt.replace(geometry=(kh, kw_, cin, cout_l))
    kw_words = -(-kh * kw_ * cin // 32)
    _check_local(qt, ops._b_planes(qt, qt.mode), cout_l, kw_words)
    spec = registry.lookup(qt.mode, backend, fused=True, layout=registry.LAYOUT_IM2COL)
    col = ops._as_col_vec(qt.scale, cout_l, x)
    b2 = None if qt.bias is None else ops._as_col_vec(qt.bias, cout_l, x)
    out = spec.fn(x, conv_fused.conv_weight_planes(local), local.geometry, stride, padding,
                  act_stats, col, b2)
    return _gather(out, mesh, plan.n_axis)
