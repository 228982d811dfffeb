"""Public entry points of the kernels: ``pack_weights``, ``qmm``,
``qconv``.

Counterpart of the GeMM and conv half of ``repro/kernels/ops.py``:

* ``pack_weights(w, mode)`` (== :meth:`QTensor.from_dense`) — offline
  packing, the paper's Algorithm 2 PackedB;
* ``qmm(x, qt)`` — float activations x packed weights -> float32:
  ternarize/binarize -> pack -> popcount GeMM -> eq. (2) epilogue, the
  last two in one kernel launch on the card; u8/u4 run the affine eq. (3)
  pipeline (raw accumulator kernel, rank-1 zero-point terms, eq. (2));
  f32/bf16 are a float32 product;
* ``qmm_grouped(x, qts, counts, sizes)`` — one ``qmm`` a group of rows against
  the group's entry of stacked containers (the routed experts), tnn and
  tbn in one quantization and one kernel launch a container;
* ``qconv(x, qt)`` — the low-bit modes through an implicit-im2col conv
  kernel;
* ``packed_matmul(xa, qt)`` — the low-bit int32 core alone;
* ``lowbit_matmul``, ``int8_affine_matmul``, ``int4_affine_matmul`` —
  the integer cores on unpacked operands (Table III's entries);
* ``quantized_matmul(x, w, mode)`` — float master weights, the QAT
  forward (``qmm`` on ``w`` packed per call) with straight-through
  gradients, a ``torch.autograd.Function``.

Kernels are chosen through :mod:`repro_torch.kernels.registry`; the
backend ``"cuda"`` (the default) launches the Hopper kernels on CUDA
tensors and runs their plain versions on CPU tensors, ``"torch"`` runs
the plain versions anywhere, ``"dense"`` the tensor-core kernels of
:mod:`repro_torch.kernels.dense_fused`.  A failing launch raises: there
is no fallback chain.

The blocking of a ``qmm`` request comes from the autotuner's plan cache
(``repro_torch.tune.cache.plan_for``, one dict lookup once resolved):
a tuned plan's CTA tile for the CUDA GeMMs (popcount, dense, u8/u4) or
``word_chunk`` / ``seg_bits`` for the plain and indexed cells; without a
plan, ``_matmul_common.gemm_tile``'s tile for the shape.  Under the
"on_first_use" policy a new shape is tuned first
(``tune.tuner.ensure_plan``).  The conv kernels' tiles are compiled in.
Every ``qmm`` / ``qconv`` request counts in ``repro_qmm_dispatch_total``
/ ``repro_qconv_dispatch_total`` (obs-gated) and passes the
``kernel.compile`` fault point before its launch.

Not ported (see ROADMAP.md): the reference's fallback chain
(``fallback_decisions`` / ``reset_fallbacks``, pallas -> xla -> oracle
with a cached decision): a failed or injected launch raises to the
caller (in the serving engine, ``Engine.run`` quarantines the step);
the retrace counters ``qmm_trace_count`` / ``qconv_trace_count``
(nothing traces in PyTorch); and the deprecated ``fused_qmm`` shim (call
``qmm`` with a QTensor).

Inside ``parallel.sharding.use_mesh``, a container whose ``pspec`` names
live mesh axes dispatches to the mesh path
(:mod:`repro_torch.parallel.qmm_mesh`) with the requested backend, before
the ``kernel.compile`` point, as in the reference: n-sharded planes run
the fused kernel on their output slice, k-sharded planes all-reduce int32
partial counts and apply eq. (2) after the sum; the outputs are
``torch.equal`` to the single-device ones.

The indexed backend (``backend="indexed"``,
:mod:`repro_torch.kernels.indexed_matmul`) is plain PyTorch on any
device; its cells read the weight QTensor's payload (``payload_aware``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import encoding, quantize
from repro_torch.kernels import conv_fused, dense_fused, registry
from repro_torch.kernels import indexed_matmul as _indexed_matmul
from repro_torch.kernels._matmul_common import (
    DEFAULT_TILES, TileConfig, lowbit_matmul_grouped_call, scale_epilogue)
from repro_torch.kernels.bnn_matmul import (
    bnn_matmul_cuda, bnn_matmul_fused_cuda, bnn_matmul_fused_torch,
    bnn_matmul_torch)
from repro_torch.kernels.int4_matmul import (
    int4_matmul_cuda, int4_matmul_torch, pack_nibbles_cols, pack_nibbles_rows)
from repro_torch.kernels.int8_matmul import int8_matmul_cuda, int8_matmul_torch
from repro_torch.kernels.modes import DEFAULT_BACKEND, QuantMode
from repro_torch.kernels.qtensor import PAYLOAD_KEYS, QTensor
from repro_torch.kernels.tbn_matmul import (
    tbn_matmul_cuda, tbn_matmul_fused_cuda, tbn_matmul_fused_torch,
    tbn_matmul_torch)
from repro_torch.kernels.tnn_matmul import (
    tnn_matmul_cuda, tnn_matmul_fused_cuda, tnn_matmul_fused_torch,
    tnn_matmul_torch)
from repro_torch.resilience import faults
from repro_torch.tune import cache as tune_cache
from repro_torch.tune.space import AFFINE_SPACE, AFFINE_TORCH_SPACE, GEMM_SPACE, TORCH_SPACE

__all__ = ["QuantMode", "QTensor", "qmm", "qmm_grouped", "qconv", "pack_weights",
           "quantize_activations", "quantize_groups", "packed_matmul", "has_conv_kernel",
           "lowbit_matmul", "int8_affine_matmul", "int4_affine_matmul",
           "quantized_matmul", "row_parallel_group", "split_batch_stats_many",
           "split_weight_stats_many", "affine_weight_stats", "DEFAULT_BACKEND"]

# Planes each mode consumes on the ACTIVATION side (weights use
# qtensor.PAYLOAD_KEYS); TBN is ternary activations x binary weights.
# The affine modes carry the quantized grid plus its zero point — the
# eq. (3) core needs both operands' zeros.
_A_KEYS: Dict[QuantMode, Tuple[str, ...]] = {
    QuantMode.BNN: ("bits",),
    QuantMode.TNN: ("plus", "minus"),
    QuantMode.TBN: ("plus", "minus"),
    QuantMode.INT8: ("q", "zero"),
    QuantMode.INT4: ("q", "zero"),
}


# ---------------------------------------------------------------------------
# Registry entries — normalized (a_planes, b_planes, ...) adapters
# ---------------------------------------------------------------------------

def _register_all_kernels():
    M = QuantMode
    kernels = {
        ("cuda", M.BNN, False): bnn_matmul_cuda,
        ("cuda", M.BNN, True): bnn_matmul_fused_cuda,
        ("cuda", M.TNN, False): tnn_matmul_cuda,
        ("cuda", M.TNN, True): tnn_matmul_fused_cuda,
        ("cuda", M.TBN, False): tbn_matmul_cuda,
        ("cuda", M.TBN, True): tbn_matmul_fused_cuda,
        ("torch", M.BNN, False): bnn_matmul_torch,
        ("torch", M.BNN, True): bnn_matmul_fused_torch,
        ("torch", M.TNN, False): tnn_matmul_torch,
        ("torch", M.TNN, True): tnn_matmul_fused_torch,
        ("torch", M.TBN, False): tbn_matmul_torch,
        ("torch", M.TBN, True): tbn_matmul_fused_torch,
    }

    def make(mode, kernel, fused, plain):
        def extra(tiles):
            if not plain:
                return {"tile": tiles and tiles.cta_tile}
            return {"word_chunk": (tiles or DEFAULT_TILES[mode.value]).word_chunk}

        def unfused_fn(a, b, k, *, tiles: Optional[TileConfig] = None):
            return kernel(*a, *b, k, **extra(tiles))

        def fused_fn(a, b, k, r, c, bias, *,
                     tiles: Optional[TileConfig] = None):
            return kernel(*a, *b, k, r, c, bias, **extra(tiles))

        return fused_fn if fused else unfused_fn

    for (backend, mode, fused), kernel in kernels.items():
        plain = backend == "torch"
        registry.register(
            mode, backend, fused=fused,
            epilogue=("post-core" if plain else "in-kernel") if fused else "none",
            compute="torch-popcount" if plain else "cuda-popcount",
            tunable=TORCH_SPACE if plain else GEMM_SPACE,
            description=("chunked popcount in plain PyTorch" if plain else
                         "csrc/lowbit_gemm.cu, int32 registers")
                        + ("; eq. (2) epilogue" if fused else ""),
        )(make(mode, kernel, fused, plain))

    def make_dense_unfused(mode):
        def fn(a, b, k, *, tiles=None):
            return dense_fused.dense_matmul_torch(mode, a, b, k)
        return fn

    # The materializing unpack is only the UNFUSED dense cell: the oracle
    # of the tensor-core kernels (kernels/dense_fused.py registers the
    # fused cells), plain PyTorch on any device.
    for mode in (M.BNN, M.TNN, M.TBN):
        registry.register(
            mode, "dense", fused=False, epilogue="none", compute="torch-dense",
            description="materializing oracle: unpack the whole payload to "
                        "+-1/0 float32, one exact product",
        )(make_dense_unfused(mode))


_register_all_kernels()


# ---------------------------------------------------------------------------
# Affine (u8/u4) cells: eq. (3) zero-point core + eq. (2) epilogue
# ---------------------------------------------------------------------------

def _int_scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A zero point (tensor or Python int) as an int32 scalar on
    ``like``'s device; a Python int is filled there (no host sync)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=torch.int32).reshape(())
    return torch.full((), int(v), dtype=torch.int32, device=like.device)


def _affine_core(mode: QuantMode, a_pl, b_pl, k_valid: int, *,
                 kernel: bool, tile: Optional[int] = None) -> torch.Tensor:
    """int32 c~ per eq. (3).  ``a_pl``/``b_pl`` are the (grid, zero)
    pairs of ``_A_KEYS``/``_b_planes``: a_q (m, k) and b_q (k, n)
    u8/u4-valued, za/zb their zero points.  The raw accumulator comes
    from the u8/u4 kernel (``kernel``) or its plain version; the rank-1
    terms stay in plain PyTorch, as the reference applies them outside
    Pallas.  ``tile``: the kernel's CTA tile (``_matmul_common.cta_tile``)."""
    a_q, za = a_pl
    b_q, zb = b_pl
    # Unsigned 8-bit operands: widen from uint8 so 128..255 survive.
    a8, b8 = a_q.to(torch.uint8), b_q.to(torch.uint8)
    if mode == QuantMode.INT8:
        acc = int8_matmul_cuda(a8, b8, tile) if kernel else int8_matmul_torch(a8, b8)
    else:
        a4, b4 = pack_nibbles_rows(a8), pack_nibbles_cols(b8)
        acc = int4_matmul_cuda(a4, b4, tile) if kernel else int4_matmul_torch(a4, b4)
    rows = a_q.to(torch.int32).sum(dim=1, dtype=torch.int32)
    cols = b_q.to(torch.int32).sum(dim=0, dtype=torch.int32)
    za, zb = _int_scalar(za, acc), _int_scalar(zb, acc)
    return acc - zb * rows[:, None] - za * cols[None, :] + k_valid * za * zb


def _register_affine_kernels():
    def make(mode, kernel, fused):
        def unfused_fn(a, b, k, *, tiles=None):
            return _affine_core(mode, a, b, k, kernel=kernel, tile=tiles and tiles.cta_tile)

        def fused_fn(a, b, k, r, c, bias, *, tiles=None):
            return scale_epilogue(_affine_core(mode, a, b, k, kernel=kernel,
                                               tile=tiles and tiles.cta_tile), r, c, bias)

        return fused_fn if fused else unfused_fn

    for mode in (QuantMode.INT8, QuantMode.INT4):
        for backend in ("cuda", "torch"):
            kernel = backend == "cuda"
            core = ("csrc/affine_gemm.cu raw accumulator" if kernel else
                    "exact float64 product")
            for fused in (False, True):
                registry.register(
                    mode, backend, fused=fused,
                    epilogue="post-core" if fused else "none",
                    compute="cuda-imma" if kernel else "torch-int",
                    tunable=AFFINE_SPACE if kernel else AFFINE_TORCH_SPACE,
                    description=f"{core}; eq. (3) zero-point terms in torch"
                                + ("; eq. (2) epilogue" if fused else ""),
                )(make(mode, kernel, fused))


_register_affine_kernels()


def _affine_backend(mode: QuantMode, backend: str, *, fused: bool) -> str:
    """Effective affine backend: the requested one when registered,
    otherwise :data:`DEFAULT_BACKEND` — the Hopper kernel on the card, so
    a low-bit backend name such as "dense" never quietly turns into the
    plain version."""
    return backend if registry.has(mode, backend, fused=fused) else DEFAULT_BACKEND


def int8_affine_matmul(a_q: torch.Tensor, b_q: torch.Tensor, za, zb,
                       k_valid: int, *,
                       backend: str = DEFAULT_BACKEND) -> torch.Tensor:
    """c~ per eq. (3) -> int32 (m, n).  a_q (m, k), b_q (k, n) u8-valued."""
    backend = _affine_backend(QuantMode.INT8, backend, fused=False)
    spec = registry.lookup(QuantMode.INT8, backend, fused=False)
    return spec.fn((a_q, za), (b_q, zb), k_valid)


def int4_affine_matmul(a_q: torch.Tensor, b_q: torch.Tensor, za, zb,
                       k_valid: int, *,
                       backend: str = DEFAULT_BACKEND) -> torch.Tensor:
    """c~ per eq. (3) -> int32 (m, n).  a_q (m, k), b_q (k, n) u4-valued."""
    backend = _affine_backend(QuantMode.INT4, backend, fused=False)
    spec = registry.lookup(QuantMode.INT4, backend, fused=False)
    return spec.fn((a_q, za), (b_q, zb), k_valid)


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

def pack_weights(w: torch.Tensor, mode: QuantMode, *,
                 per_channel: bool = True,
                 indexed_bits: Optional[int] = None) -> QTensor:
    """Offline weight packing (Algorithm 2's PackedB): (k, n) float ->
    :class:`QTensor` on ``w``'s device.  ``indexed_bits`` (2/4/8) also
    stores the segment indices the indexed backend reads
    (``idx{b}_*`` payload keys); without them it derives them, with the
    same result."""
    qt = QTensor.from_dense(w, mode, per_channel=per_channel)
    if indexed_bits is not None:
        qt = _indexed_matmul.add_indexed_payload(qt, indexed_bits)
    return qt


def _stat(v, like: torch.Tensor) -> torch.Tensor:
    """A statistic (tensor, numpy or Python scalar) as a float32 scalar
    tensor on ``like``'s device."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v, dtype=np.float32))
    return v.to(device=like.device, dtype=torch.float32).reshape(())


def quantize_activations(x: torch.Tensor, mode: QuantMode, *,
                         stats: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
    """Runtime activation quantization of (m, k) float ``x``: a dict of
    packed planes plus the per-tensor ``scale``; for u8/u4 the affine grid
    ``q`` with its ``scale`` and ``zero``; for f32/bf16 ``{"x": x}``.

    ``stats`` optionally supplies the per-tensor statistics ({"thr",
    "scale"} for ternary modes, {"scale"} for BNN, {"scale", "zero"} for
    u8/u4) instead of deriving them from ``x`` — the conv oracle passes
    ``conv_act_stats`` here, a split batch :func:`split_batch_stats`.
    """
    if mode.is_float:
        return {"x": x}
    with obs.annotate("repro_torch.quantize"):
        if mode in (QuantMode.INT8, QuantMode.INT4):
            bits = 8 if mode == QuantMode.INT8 else 4
            q = (quantize.affine_calibrate(x, bits) if stats is None else
                 quantize.AffineQuant(scale=_stat(stats["scale"], x),
                                      zero_point=stats["zero"].to(x.device), bits=bits))
            return {"q": quantize.affine_quantize(x, q), "scale": q.scale,
                    "zero": q.zero_point}
        if mode in (QuantMode.TNN, QuantMode.TBN):
            if stats is not None:
                t, _ = quantize.ternarize(x, threshold=_stat(stats["thr"], x))
                scale = _stat(stats["scale"], x)
            else:
                t, scale = quantize.ternarize(x)
            plus, minus = encoding.pack_ternary(t)
            return {"plus": plus, "minus": minus, "scale": scale}
        b, scale = quantize.binarize(x)
        if stats is not None:
            scale = _stat(stats["scale"], x)
        return {"bits": encoding.pack_binary(b), "scale": scale}


def _b_planes(wb: QTensor, mode: QuantMode) -> Tuple[torch.Tensor, ...]:
    """Weight-side operand tuple: the mode's payload planes, plus the zero
    point for the affine modes (the eq. (3) core consumes (grid, zero)
    pairs on both sides)."""
    planes = tuple(wb.payload[k] for k in PAYLOAD_KEYS[mode])
    if mode in (QuantMode.INT8, QuantMode.INT4):
        return planes + (wb.zero,)
    return planes


def packed_matmul(xa: Dict[str, Any], wb: QTensor,
                  mode: Optional[QuantMode] = None, *,
                  backend: str = DEFAULT_BACKEND) -> torch.Tensor:
    """Integer core: packed activations x packed weights -> int32 (m, n)
    (BNN already finalized by eq. (6))."""
    if not isinstance(wb, QTensor):
        raise TypeError(f"packed_matmul expects a QTensor weight operand; "
                        f"got {type(wb).__name__}")
    if mode is not None and mode != wb.mode:
        raise ValueError(f"mode mismatch: {mode} vs QTensor {wb.mode}")
    mode = wb.mode
    if not mode.is_lowbit:
        raise ValueError(f"packed_matmul only handles low-bit modes, got {mode}")
    spec = registry.lookup(mode, backend, fused=False)
    a_pl = tuple(xa[k] for k in _A_KEYS[mode])
    extra = {"payload": wb.payload} if spec.payload_aware else {}
    return spec.fn(a_pl, _b_planes(wb, mode), wb.k_valid, **extra)


# ---------------------------------------------------------------------------
# qmm — float x QTensor -> float32
# ---------------------------------------------------------------------------

def _as_row_scale(scale, m: int, like: torch.Tensor) -> torch.Tensor:
    """Activation scale (scalar or (m,)) -> (1, 1) or (m, 1) float32.  A
    per-tensor scale stays one value: the kernels read it with row stride
    0 and the plain versions broadcast it, so no (m, 1) copy is made."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=like.device)
    return s.reshape(1, 1) if s.ndim == 0 else s.reshape(m, 1)


def _as_col_vec(v, n: int, like: torch.Tensor) -> torch.Tensor:
    """Weight scale / bias (scalar or (n,)) -> (1, n) float32, contiguous
    (the kernels read n values)."""
    x = torch.as_tensor(v, dtype=torch.float32, device=like.device)
    if x.ndim == 0:
        return x.reshape(1, 1).expand(1, n).contiguous()
    return x.reshape(1, n)


def _check_qtensor(qt: QTensor, what: str, *, lowbit: bool) -> None:
    if not isinstance(qt, QTensor):
        raise TypeError(f"{what} expects a QTensor, got {type(qt).__name__}")
    if lowbit and not qt.is_lowbit:
        raise ValueError(f"{what}: mode {qt.mode.value} has no kernel here; "
                         f"low-bit modes only")


def _float_passthrough(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """f32/bf16: ``x`` cast to the payload's type, a float32 product (TF32
    off; bf16 operands multiply exactly in float32), then the bias — as
    the reference's ``jnp.dot(..., preferred_element_type=f32)``."""
    from repro_torch.core.conv import matmul_f32   # core.conv imports ops

    w = qt.payload["w"]
    y = matmul_f32(x.to(w.dtype), w)
    return y if qt.bias is None else y + qt.bias


_QMM_DISPATCH_CTR = obs.get_registry().counter(
    "repro_qmm_dispatch_total",
    "qmm host-side dispatches by (mode, backend, layout)",
    labels=("mode", "backend", "layout"))
_QCONV_DISPATCH_CTR = obs.get_registry().counter(
    "repro_qconv_dispatch_total",
    "qconv host-side dispatches by (mode, backend, layout)",
    labels=("mode", "backend", "layout"))


def _plan_tiles(spec, mode: QuantMode, backend: str, m: int, n: int, k: int,
                device: torch.device, fused: bool = True) -> Optional[TileConfig]:
    """The blocking of one request (a mesh rank's local one too): the
    plan cache's (tuned on first use under that policy), or None for a
    cell with no space."""
    if spec.tunable is None:
        return None
    if tune_cache.get_policy() == "on_first_use":
        from repro_torch.tune import tuner     # tuner imports ops

        tuner.ensure_plan(mode, backend, fused=fused, m=m, n=n, k=k, device=device)
    return tune_cache.plan_for(mode, backend, fused=fused, m=m, n=n, k=k,
                               device=device).tiles


def qmm(x: torch.Tensor, qt: QTensor, *, backend: Optional[str] = None,
        act_stats: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Quantized matmul: float ``x`` (m, k) against a :class:`QTensor` ->
    float32 (m, n).

    Low-bit modes: quantize and pack ``x`` (per-tensor TWN / mean-abs
    statistics, or ``act_stats``), then one fused kernel: popcount (or,
    on ``backend="dense"``, tensor-core) core + eq. (2)
    ``acc * row_scale * col_scale (+ bias)``.  u8/u4: affine-quantize
    ``x``, the eq. (3) core and the same epilogue; a backend with no
    affine cell (e.g. "dense") runs the affine cell of
    :data:`DEFAULT_BACKEND`.  f32/bf16: a float32 product (+ bias).
    ``backend`` None -> :data:`DEFAULT_BACKEND` ("cuda"); the device is
    ``x``'s, and ``qt`` must lie on it.  The blocking comes from the plan
    cache (module docstring); a failing launch, or an armed
    ``kernel.compile`` fault, raises — there is no fallback.
    """
    with obs.annotate("repro_torch.qmm"):
        _check_qtensor(qt, "qmm", lowbit=False)
        if x.ndim != 2:
            raise ValueError(f"qmm expects x of rank 2, got shape {tuple(x.shape)}")
        if x.shape[-1] != qt.k_valid:
            raise ValueError(
                f"depth mismatch: x has k={x.shape[-1]} but QTensor was packed "
                f"with k_valid={qt.k_valid} (logical shape {qt.shape})")
        backend = backend or DEFAULT_BACKEND
        m, k = x.shape
        n = qt.out_features
        mode = qt.mode
        if mode in (QuantMode.INT8, QuantMode.INT4):
            backend = _affine_backend(mode, backend, fused=True)
        _QMM_DISPATCH_CTR.inc(mode=mode.value, backend=backend, layout=registry.LAYOUT_GEMM)
        if qt.pspec is not None and mode.is_lowbit:
            from repro_torch.parallel import qmm_mesh, sharding   # qmm_mesh imports ops

            ctx = sharding.active()
            plan = None if ctx is None else qmm_mesh.shard_plan(qt, ctx)
            if plan is not None:
                # the mesh path keeps the requested backend
                return qmm_mesh.qmm_sharded(x, qt, plan, ctx.mesh, backend=backend,
                                            act_stats=act_stats)
            qmm_mesh.check_whole(qt)
        faults.maybe_raise("kernel.compile", op="qmm", mode=mode.value, backend=backend)
        if mode.is_float:
            return _float_passthrough(x, qt)
        spec = registry.lookup(mode, backend, fused=True)
        tiles = _plan_tiles(spec, mode, backend, m, n, k, x.device)
        xa = quantize_activations(x.to(torch.float32), mode, stats=act_stats)
        row = _as_row_scale(xa["scale"], m, x)
        col = _as_col_vec(qt.scale, n, x)
        b2 = None if qt.bias is None else _as_col_vec(qt.bias, n, x)
        a_pl = tuple(xa[kk] for kk in _A_KEYS[mode])
        extra = {"payload": qt.payload} if spec.payload_aware else {}
        with obs.annotate("repro_torch.lowbit_kernel"):
            return spec.fn(a_pl, _b_planes(qt, mode), k, row, col, b2, tiles=tiles,
                           **extra)


def quantize_groups(x: torch.Tensor, counts: torch.Tensor,
                    sizes: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Ternary activation quantization of (G, R, k) float32 ``x`` a group
    at a time: group g's rows are ``x[g, :counts[g]]`` and the rows past
    them are zero (``counts`` on ``x``'s device, ``sizes`` the same on the
    host).  -> {"plus", "minus": (G * R, kw) int32 planes, "scale": (G,)
    float32}.

    Each group's threshold is :func:`quantize.ternarize`'s over its own
    rows, bit for bit: 0.7 of the sum of |x| over those rows (one
    reduction a group, of the same shape as ``quantize_activations``
    makes) over their count times k.  A threshold sits among values of
    the bf16 stream, where another reduction order moves many
    activations across it at once; the scale, the mean |x| above it,
    moves the output by its last bit alone, so one reduction over every
    group gives it.  The zero rows stay (0, 0) words: no zero lies above
    a threshold, which is never negative.
    """
    with obs.annotate("repro_torch.quantize"):
        g, r, k = x.shape
        a = x.abs()
        sums = torch.stack([a[i, :c].sum() if c else a.new_zeros(())
                            for i, c in enumerate(sizes)])
        thr = 0.7 * (sums / (counts.to(torch.float32).clamp(min=1) * float(k)))
        mask = a > thr[:, None, None]
        denom = mask.sum(dim=(1, 2)).clamp(min=1).to(torch.float32)
        scale = (a * mask).sum(dim=(1, 2)) / denom
        mask = mask.reshape(g * r, k)
        x2 = x.reshape(g * r, k)
        return {"plus": encoding.pack_bits(mask & (x2 > 0)),
                "minus": encoding.pack_bits(mask & (x2 < 0)), "scale": scale}


def _col_rows(v, g: int, n: int) -> Optional[torch.Tensor]:
    """A stacked container's scale / bias ((G,), (G, 1) or (G, n)) ->
    (G, n) float32, contiguous (one row of n a group), or None."""
    if v is None:
        return None
    return v.to(torch.float32).reshape(g, -1).expand(g, n).contiguous()


def qmm_grouped(x: torch.Tensor, qts: Sequence[QTensor], counts: torch.Tensor,
                sizes: Sequence[int], *, backend: Optional[str] = None) -> List[torch.Tensor]:
    """Grouped quantized matmul: float ``x`` (G, R, k), group g's rows
    ``x[g, :counts[g]]`` and zeros past them, against entry g of each
    container of ``qts`` (stacked over G, all of one mode) -> a float32
    (G, R, n) a container, zero at each group's rows past its count.
    ``counts`` (G,) integers on ``x``'s device, ``sizes`` the same on the
    host.

    Each group's product is a ``qmm`` of its own rows: its activation
    statistics cover those rows only.  Under tnn and tbn the groups share
    one quantization (:func:`quantize_groups`), which every container of
    ``qts`` reuses, and on the "cuda" backend with CUDA planes each
    container is one launch of the grouped kernel
    (``_matmul_common.lowbit_matmul_grouped_call``); elsewhere the mode's
    kernel a group.  Other modes: one ``qmm`` a group.
    """
    backend = backend or DEFAULT_BACKEND
    g, r, k = x.shape
    mode = qts[0].mode
    for qt in qts:
        _check_qtensor(qt, "qmm_grouped", lowbit=False)
        if qt.mode != mode or not qt.stacked or qt.k_valid != k:
            raise ValueError(f"qmm_grouped: containers of mode {mode.value}, stacked over "
                             f"{g} groups, of depth {k}; got {qt!r}")

    def zeros(qt):
        return torch.zeros((g, r, qt.out_features), dtype=torch.float32, device=x.device)

    with obs.annotate("repro_torch.qmm"):
        if mode not in (QuantMode.TNN, QuantMode.TBN):
            outs = [zeros(qt) for qt in qts]
            for i, c in enumerate(sizes):
                for out, qt in zip(outs, qts):
                    if c:
                        out[i, :c] = qmm(x[i, :c], qt.period(i), backend=backend)
            return outs
        xa = quantize_groups(x.to(torch.float32), counts, sizes)
        a_pl = tuple(xa[kk] for kk in _A_KEYS[mode])
        grouped = x.is_cuda and backend == DEFAULT_BACKEND
        if grouped:
            counts32 = counts.to(torch.int32)
        else:
            spec = registry.lookup(mode, backend, fused=True)
        outs = []
        for qt in qts:
            n = qt.out_features
            col, bias = _col_rows(qt.scale, g, n), _col_rows(qt.bias, g, n)
            b_pl = _b_planes(qt, mode)
            if grouped:
                with obs.annotate("repro_torch.lowbit_kernel"):
                    outs.append(lowbit_matmul_grouped_call(
                        mode, a_pl, b_pl, counts32, k, xa["scale"], col, bias))
                continue
            out = zeros(qt)
            with obs.annotate("repro_torch.lowbit_kernel"):
                for i, c in enumerate(sizes):
                    if not c:
                        continue
                    extra = {"payload": qt.period(i).payload} if spec.payload_aware else {}
                    out[i, :c] = spec.fn(tuple(p[i * r:i * r + c] for p in a_pl),
                                         tuple(p[i] for p in b_pl), k,
                                         xa["scale"][i].reshape(1, 1), col[i:i + 1],
                                         None if bias is None else bias[i:i + 1],
                                         tiles=None, **extra)
            outs.append(out)
    return outs


def _qmm_oracle(x: torch.Tensor, qt: QTensor,
                act_stats: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Materializing oracle (counterpart of ``_qmm_oracle_jit``): the
    unfused ``(mode, "dense")`` cell — unpack both operands to ±1/0
    values, one exact product — then the eq. (2) epilogue in plain
    torch."""
    _check_qtensor(qt, "qmm oracle", lowbit=True)
    m, k = x.shape
    mode = qt.mode
    xa = quantize_activations(x.to(torch.float32), mode, stats=act_stats)
    spec = registry.lookup(mode, "dense", fused=False)
    acc = spec.fn(tuple(xa[kk] for kk in _A_KEYS[mode]), _b_planes(qt, mode), k)
    row = _as_row_scale(xa["scale"], m, x)
    col = _as_col_vec(qt.scale, qt.out_features, x)
    b2 = None if qt.bias is None else _as_col_vec(qt.bias, qt.out_features, x)
    return scale_epilogue(acc, row, col, b2)


# ---------------------------------------------------------------------------
# qconv — packed conv through the implicit-im2col kernel
# ---------------------------------------------------------------------------

def has_conv_kernel(mode: QuantMode, backend: str) -> bool:
    """True when an implicit-im2col conv kernel is registered for (mode,
    backend) — what conv2d_packed's dispatch consults."""
    return registry.has(mode, backend, fused=True,
                        layout=registry.LAYOUT_IM2COL)


def qconv(x: torch.Tensor, qt: QTensor, *, stride: int = 1,
          padding: str = "SAME", backend: Optional[str] = None,
          act_stats: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Packed conv: float ``x`` (B, H, W, Cin) NHWC against a conv QTensor
    (``pack_conv_filters``) -> float32 (B, OH, OW, Cout), never
    materializing the im2col matrix.  ``act_stats`` defaults to
    :func:`conv_fused.conv_act_stats` of ``x``; bit-identical to the
    materializing oracle (im2col + :func:`qmm` with the same stats).  A
    failing launch, or an armed ``kernel.compile`` fault, raises."""
    with obs.annotate("repro_torch.qconv"):
        _check_qtensor(qt, "qconv", lowbit=True)
        if qt.geometry is None:
            raise ValueError("qconv needs a QTensor packed with "
                             "pack_conv_filters (geometry missing)")
        if x.ndim != 4:
            raise ValueError(f"qconv expects x of rank 4 (B, H, W, Cin), got "
                             f"shape {tuple(x.shape)}")
        kh, kw_, cin, cout = qt.geometry
        if x.shape[-1] != cin:
            raise ValueError(f"channel mismatch: x has Cin={x.shape[-1]} but "
                             f"QTensor geometry is {qt.geometry}")
        backend = backend or DEFAULT_BACKEND
        _QCONV_DISPATCH_CTR.inc(mode=qt.mode.value, backend=backend,
                                layout=registry.LAYOUT_IM2COL)
        x = x.to(torch.float32).contiguous()
        if act_stats is None:
            stats = conv_fused.conv_act_stats(x, qt.mode, kh, kw_, stride, padding)
        else:
            stats = {k: _stat(v, x) for k, v in act_stats.items()}
        if qt.pspec is not None:
            from repro_torch.parallel import qmm_mesh, sharding   # qmm_mesh imports ops

            ctx = sharding.active()
            plan = None if ctx is None else qmm_mesh.shard_plan_conv(qt, ctx)
            if plan is not None:
                return qmm_mesh.qconv_sharded(x, qt, plan, ctx.mesh, stats, backend=backend,
                                              stride=stride, padding=padding)
            qmm_mesh.check_whole(qt)
        faults.maybe_raise("kernel.compile", op="qconv", mode=qt.mode.value, backend=backend)
        spec = registry.lookup(qt.mode, backend, fused=True,
                               layout=registry.LAYOUT_IM2COL)
        col = _as_col_vec(qt.scale, cout, x)
        b2 = None if qt.bias is None else _as_col_vec(qt.bias, cout, x)
        with obs.annotate("repro_torch.lowbit_kernel"):
            return spec.fn(x, conv_fused.conv_weight_planes(qt), qt.geometry,
                           stride, padding, stats, col, b2)


def _qconv_oracle(x: torch.Tensor, qt: QTensor, act_stats, stride: int,
                  padding: str) -> torch.Tensor:
    """Conv oracle (counterpart of ``_qconv_oracle_jit``): materialize the
    im2col matrix and run :func:`_qmm_oracle` — for the tests."""
    from repro_torch.core.conv import im2col   # core.conv imports ops

    kh, kw_, _, cout = qt.geometry
    patches, (b, oh, ow) = im2col(x.to(torch.float32), kh, kw_, stride,
                                  padding)
    return _qmm_oracle(patches, qt, act_stats=act_stats).reshape(b, oh, ow,
                                                                 cout)


# ---------------------------------------------------------------------------
# Float-facing quantized matmul with STE gradients (QAT)
# ---------------------------------------------------------------------------

def _affine_ranges(ts: Sequence[torch.Tensor], mode: QuantMode,
                   reduce) -> List[Dict[str, torch.Tensor]]:
    """The per-tensor affine grid ({"scale", "zero"}) of each whole tensor
    of which each of ``ts`` holds a part: every part's max and -min in one
    collective, ``reduce(t, "max")``, then ``quantize.affine_from_range``.
    Max and min do not depend on the order, so each grid is
    ``affine_calibrate``'s of the whole tensor exactly."""
    r = reduce(torch.stack([v for t in ts for v in (t.amax(), -t.amin())]).to(torch.float32),
               "max")
    bits = 8 if mode == QuantMode.INT8 else 4
    out = []
    for i in range(len(ts)):
        q = quantize.affine_from_range(-r[2 * i + 1], r[2 * i], bits)
        out.append({"scale": q.scale, "zero": q.zero_point})
    return out


def affine_weight_stats(w: torch.Tensor, mode: QuantMode) -> Dict[str, torch.Tensor]:
    """The INT8/INT4 grid of the whole weight ``w`` a rank holds, for a
    projection that computes with a part of it (Mamba2's ``in_proj`` on a
    rank's heads' columns): no collective."""
    q = quantize.affine_calibrate(w, 8 if mode == QuantMode.INT8 else 4)
    return {"scale": q.scale, "zero": q.zero_point}


def split_batch_stats_many(xs: Sequence[torch.Tensor], mode: QuantMode, split,
                           over_tp: bool = False) -> List[Dict[str, Any]]:
    """The per-tensor activation statistics of the global batch whose rows
    each ``x`` (m, k) of ``xs`` holds this rank's share of
    (``sharding.split_batch``): the same formulas as
    :func:`quantize_activations` derives from a whole ``x``, with every sum
    and count summed over the batch axes (float64 partial sums, so the
    result is the exact sum rounded once to float32, a few ULPs from one
    device's float32 sum) and the affine range's min / max reduced exactly.
    ``over_tp``: over the tensor-parallel axis too (a row-parallel
    projection's input, this rank's k slice).  Every tensor's sums travel
    in one collective per round (the ternary threshold needs two), so the
    experts of an MoE layer reduce their statistics together."""
    xs = [x.to(torch.float32) for x in xs]
    f64 = torch.float64
    red = split.reduce_all if over_tp else split.reduce
    if mode in (QuantMode.INT8, QuantMode.INT4):
        return _affine_ranges(xs, mode, red)
    a = [x.abs() for x in xs]
    tot = red(torch.stack([v for t in a for v in (
        t.sum(dtype=f64), torch.full((), t.numel(), dtype=f64, device=t.device))]))
    means = [tot[2 * i].to(torch.float32) / tot[2 * i + 1].to(torch.float32)
             for i in range(len(a))]
    if mode == QuantMode.BNN:
        return [{"scale": mean} for mean in means]
    thr = [0.7 * mean for mean in means]
    kept = red(torch.stack([v for t, th in zip(a, thr) for v in (
        (t * (t > th)).sum(dtype=f64), (t > th).sum().to(f64))]))
    return [{"thr": thr[i], "scale": kept[2 * i].to(torch.float32)
             / kept[2 * i + 1].to(torch.float32).clamp(min=1)} for i in range(len(a))]


def split_batch_stats(x: torch.Tensor, mode: QuantMode, split,
                      over_tp: bool = False) -> Dict[str, Any]:
    """:func:`split_batch_stats_many` of the one tensor ``x``."""
    return split_batch_stats_many([x], mode, split, over_tp)[0]


def split_weight_stats_many(ws: Sequence[torch.Tensor], mode: QuantMode,
                            split) -> List[Dict[str, torch.Tensor]]:
    """The statistics of each (k, n) weight of ``ws`` whose "model" chunk
    this rank holds along the tensor-parallel axis.  TNN/TBN/BNN: per
    output channel, for a row-parallel projection (its k rows split):
    ``QTensor.from_dense``'s TWN / mean-abs formulas over the whole depth,
    with float64 partial sums over the tensor-parallel axis (as
    :func:`split_batch_stats_many` sums rows), each rounded once to
    float32.  INT8/INT4: the per-tensor grid of the whole weight, for a
    column- or a row-parallel projection alike: each chunk's max and
    -min, their max over the tensor-parallel axis (exact).  Every weight's
    values in one collective per round.  -> the ``stats`` of
    ``QTensor.from_dense``, one per weight."""
    if mode in (QuantMode.INT8, QuantMode.INT4):
        return _affine_ranges(ws, mode, split.reduce_tp)
    a = [w.to(torch.float32).abs() for w in ws]
    f64 = torch.float64
    widths = [t.shape[1] for t in a]

    def parts(flat):
        return list(torch.split(flat, widths))

    sums = parts(split.reduce_tp(torch.cat([t.sum(dim=0, dtype=f64) for t in a])))
    means = [v.to(torch.float32) / float(t.shape[0] * split.tp_size) for v, t in zip(sums, a)]
    if mode in (QuantMode.TBN, QuantMode.BNN):
        return [{"scale": mean} for mean in means]
    thr = [0.7 * mean for mean in means]
    masks = [t > th for t, th in zip(a, thr)]
    kept = split.reduce_tp(torch.cat([torch.cat([(t * m).sum(dim=0, dtype=f64),
                                                 m.sum(dim=0).to(f64)])
                                      for t, m in zip(a, masks)]))
    out, at = [], 0
    for th, n in zip(thr, widths):
        ks, kc = kept[at:at + n], kept[at + n:at + 2 * n]
        at += 2 * n
        out.append({"thr": th, "scale": ks.to(torch.float32) / kc.to(torch.float32).clamp(min=1)})
    return out


def split_weight_stats(w: torch.Tensor, mode: QuantMode, split) -> Dict[str, torch.Tensor]:
    """:func:`split_weight_stats_many` of the one weight ``w``."""
    return split_weight_stats_many([w], mode, split)[0]


def _row_operands(x: torch.Tensor, w: torch.Tensor, mode: QuantMode, backend: str,
                  split, stats: Dict[str, Any]):
    """A row-parallel projection's operands on this rank's k slice: ``w``
    packed with the whole depth's statistics (an INT8/INT4 weight onto the
    whole weight's grid), ``x`` quantized with the global ones.  ->
    (activation words or grid, weight words or grid, the arguments of
    ``qmm_mesh.k_sharded_partial``, those of ``qmm_mesh.k_sharded_finish``)."""
    m, k_local = x.shape
    qt = QTensor.from_dense(w, mode, stats=stats["w"])
    n = qt.out_features
    if mode in (QuantMode.INT8, QuantMode.INT4):
        backend = _affine_backend(mode, backend, fused=False)
    faults.maybe_raise("kernel.compile", op="qmm", mode=mode.value, backend=backend)
    spec = registry.lookup(mode, backend, fused=False)
    tiles = _plan_tiles(spec, mode, backend, m, n, k_local, x.device, fused=False)
    xa = quantize_activations(x.to(torch.float32), mode, stats=stats["act"])
    row = _as_row_scale(xa["scale"], m, x)
    col = _as_col_vec(qt.scale, n, x)
    a_pl = tuple(xa[kk] for kk in _A_KEYS[mode])
    return (a_pl, _b_planes(qt, mode),
            dict(mode=mode, backend=backend, spec=spec, tiles=tiles, bit0=0, depth=k_local),
            dict(mode=mode, backend=backend, k=k_local * split.tp_size, row=row, col=col,
                 bias=None))


def _qmm_row_parallel(x: torch.Tensor, w: torch.Tensor, mode: QuantMode, backend: str,
                      lead, split, stats: Dict[str, Any]) -> torch.Tensor:
    """A row-parallel projection's forward on this rank's k slice: ``w``
    packed with the whole depth's statistics, the int32 core of this
    rank's words (row 4a), the partial counts reduced over the
    tensor-parallel axis (into sequence shards under ``sp``), the eq. (2)
    epilogue (``qmm_mesh.k_sharded_matmul``)."""
    from repro_torch.parallel import qmm_mesh, sharding

    a_pl, planes, part_kw, fin_kw = _row_operands(x, w, mode, backend, split, stats)
    return qmm_mesh.k_sharded_matmul(
        a_pl, planes, **part_kw, k=fin_kw["k"],
        reduce=lambda part: sharding.tp_reduce_partial(part, lead, split),
        row=fin_kw["row"], col=fin_kw["col"], bias=None)


def _tp_stats(x, w, mode: QuantMode, role: Optional[str], split, stats):
    """The statistics of one quantized projection on a split batch:
    ``stats`` ({"act", "w"}) where given, else the activations' over the
    batch axes (and the tensor-parallel axis for a row-parallel input) and
    the weight's over the tensor-parallel axis: a row-parallel weight's
    channels' over the whole depth, an INT8/INT4 weight's per-tensor grid
    whatever its role (:func:`split_weight_stats_many`)."""
    stats = dict(stats or {})
    if "act" not in stats and split is not None and (split.axes or role == "row"):
        stats["act"] = split_batch_stats(x, mode, split, over_tp=role == "row")
    affine = mode in (QuantMode.INT8, QuantMode.INT4)
    if (role == "row" or (affine and role == "col")) and stats.get("w") is None:
        stats["w"] = split_weight_stats(w, mode, split)
    return stats


def _qmm_fwd_value(x: torch.Tensor, w: torch.Tensor, mode: QuantMode,
                   backend: str, role: Optional[str] = None, lead=None,
                   stats: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """F32: a float32 product; BF16: bf16 operands, exact float32
    products and sums (never a bf16 ``torch.matmul``, which rounds its
    output to bf16); every quantized mode: ``qmm`` against ``w`` packed
    here (QAT re-packs per call; inference packs once and calls ``qmm``).
    When the batch is split over ranks (the training mesh), the
    activation statistics are the global batch's (:func:`split_batch_stats`).

    ``role`` "col" (column-parallel: ``w`` this rank's n slice, ``x`` the
    same on every rank of the tensor-parallel axis): the fused kernel on
    the slice, the weight's statistics local (per channel), or for
    INT8/INT4 the whole weight's grid (a max over the tensor-parallel
    axis).  "row" (row-parallel: ``x`` and ``w`` this rank's k slice):
    statistics over the whole depth, the partial sums (int32 counts, the
    eq. (3) cores of the affine modes, or float32 products for the float
    modes) reduced over the tensor-parallel axis into the rows of ``lead``
    this rank keeps (:func:`~repro_torch.parallel.sharding.tp_reduce_partial`).
    ``stats`` ({"act": ..., "w": ...}) replaces the statistics derived
    here."""
    from repro_torch.core.conv import matmul_f32   # core.conv imports ops
    from repro_torch.parallel import sharding

    split = sharding.batch_split()
    tp = sharding.tp_split() if role is not None else None
    if role is not None and tp is None:
        role = None
    if mode.is_float:
        y = matmul_f32(x, w) if mode == QuantMode.F32 else \
            matmul_f32(x.to(torch.bfloat16), w.to(torch.bfloat16))
        return sharding.tp_reduce_partial(y, lead, tp) if role == "row" else y
    stats = _tp_stats(x, w, mode, role, split, stats)
    if role == "row":
        return _qmm_row_parallel(x, w, mode, backend, lead, tp, stats)
    qt = QTensor.from_dense(w, mode, stats=stats.get("w"))
    return qmm(x, qt, backend=backend, act_stats=stats.get("act"))


class _QuantizedMatmul(torch.autograd.Function):
    """Straight-through at matmul granularity: the backward treats the
    whole pipeline as ``x @ w`` (reference ``ops._qmm_bwd``).  A
    row-parallel projection (``role`` "row") first gathers the cotangent of
    the rows it kept into every row of ``lead``; a column-parallel one
    returns its partial ``gx``, which the region's input sums over the
    tensor-parallel axis (``sharding.tp_enter``)."""

    @staticmethod
    def forward(ctx, x, w, mode, backend, role, lead, stats):
        ctx.save_for_backward(x, w)
        ctx.mode, ctx.role, ctx.lead = mode, role, lead
        return _qmm_fwd_value(x, w, mode, backend, role, lead, stats)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.conv import matmul_f32
        from repro_torch.parallel import sharding

        with obs.annotate("repro_torch.ste_backward"):
            x, w = ctx.saved_tensors
            g = g.to(torch.float32)
            tp = sharding.tp_split()
            if ctx.role == "row" and tp is not None:
                g = sharding.tp_gather_rows(g, ctx.lead, tp)
            gx = matmul_f32(g, w.t())
            gw = matmul_f32(x.t(), g)
            if ctx.mode.is_lowbit:
                gx = gx * (x.abs() <= 1.0)      # clip-range STE (hard tanh)
            return gx.to(x.dtype), gw.to(w.dtype), None, None, None, None, None


class _RowParallelGroup(torch.autograd.Function):
    """Row-parallel projections whose partial sums are reduced together
    (:func:`row_parallel_group`); backward: each pair's straight-through
    ``gx``, ``gw`` of :class:`_QuantizedMatmul` on its cotangent, which
    every rank of the tensor-parallel axis holds whole."""

    @staticmethod
    def forward(ctx, mode, backend, split, stats, n, *tensors):
        from repro_torch.core.conv import matmul_f32
        from repro_torch.parallel import qmm_mesh

        xs, ws = tensors[:n], tensors[n:]
        ctx.save_for_backward(*tensors)
        ctx.mode, ctx.n = mode, n
        if mode.is_float:
            ct = torch.bfloat16 if mode == QuantMode.BF16 else torch.float32
            parts = [matmul_f32(x.to(ct), w.to(ct)) for x, w in zip(xs, ws)]
            fins = None
        else:
            if stats is None:
                stats = [{"act": a, "w": st} for a, st in zip(
                    split_batch_stats_many(xs, mode, split, over_tp=True),
                    split_weight_stats_many(ws, mode, split))]
            ops_ = [_row_operands(x, w.to(torch.float32), mode, backend, split, st)
                    for x, w, st in zip(xs, ws, stats)]
            parts = [qmm_mesh.k_sharded_partial(a_pl, planes, **kw)
                     for a_pl, planes, kw, _ in ops_]
            fins = [fin for *_, fin in ops_]
        flat = split.reduce_tp(torch.cat([p.reshape(-1) for p in parts]), "sum")
        outs = [c.reshape(p.shape) for c, p in zip(torch.split(flat, [p.numel() for p in parts]),
                                                   parts)]
        if fins is not None:
            outs = [qmm_mesh.k_sharded_finish(acc, **fin) for acc, fin in zip(outs, fins)]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        from repro_torch.core.conv import matmul_f32

        with obs.annotate("repro_torch.ste_backward"):
            tensors = ctx.saved_tensors
            xs, ws = tensors[:ctx.n], tensors[ctx.n:]
            gxs, gws = [], []
            for x, w, g in zip(xs, ws, gs):
                if g is None:
                    gxs.append(None)
                    gws.append(None)
                    continue
                g = g.to(torch.float32)
                gx = matmul_f32(g, w.to(torch.float32).t())
                if ctx.mode.is_lowbit:
                    gx = gx * (x.abs() <= 1.0)      # clip-range STE (hard tanh)
                gxs.append(gx.to(x.dtype))
                gws.append(matmul_f32(x.to(torch.float32).t(), g).to(w.dtype))
            return (None, None, None, None, None, *gxs, *gws)


def row_parallel_group(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                       mode: QuantMode, backend: str = DEFAULT_BACKEND,
                       stats: Optional[Sequence[Dict[str, Any]]] = None) -> List[torch.Tensor]:
    """Row-parallel projections of one region on a tensor-parallel training
    split, reduced together: each ``xs[i]`` (m_i, k_i) is this rank's k
    slice of an input, ``ws[i]`` (k_i, n_i) its slice of the float master
    weight.  -> [(m_i, n_i) float32]: every row, the same on every rank of
    the tensor-parallel axis.  Each pair is packed and quantized with its
    own statistics over the whole depth (its activations' over the batch
    axes and the tensor-parallel axis, every pair's in one collective per
    round), its int32 partial counts are the int32 core of its words (row
    4a; for INT8/INT4 the eq. (3) core of its k slice, rows 8 / 9), and
    the partials of all pairs are summed over the tensor-parallel axis in
    one all-reduce before each pair's eq. (2) epilogue
    (``qmm_mesh.k_sharded_finish``): each sum is one device's core
    exactly.  Float policies sum their float32 partial products the same
    way.  The MoE layer's experts and shared expert run their down
    projections through it (``models/moe.py``); the backward is the
    straight-through one of :func:`quantized_matmul` on the whole
    cotangent, no collective.  ``stats`` ({"act", "w"} a pair) passes the
    statistics in."""
    from repro_torch.parallel import sharding

    split = sharding.tp_split()
    if split is None:
        raise RuntimeError("row_parallel_group: no tensor-parallel split is active")
    return list(_RowParallelGroup.apply(QuantMode(mode), backend, split, stats, len(xs),
                                        *xs, *ws))


def quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                     mode: QuantMode = QuantMode.TNN,
                     backend: str = DEFAULT_BACKEND, *, role: Optional[str] = None,
                     lead=None, stats: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """y ~= x @ w, x (m, k) and float master weights w (k, n) -> float32
    (m, n), computed through the selected quantized pipeline.

    Gradients are straight-through (standard for BNN/TNN QAT):
    ``gx = g @ w.T`` and ``gw = x.T @ g`` in float32, with a hard-tanh
    clip mask ``|x| <= 1`` on ``gx`` for the binary/ternary modes
    (XNOR-Net).

    On a tensor-parallel training split ``role`` says how the projection
    splits (:func:`_qmm_fwd_value`): "col" on its n slice, "row" on its k
    slice, whose output is then the rows of ``lead`` (the leading dims of
    ``x``'s rows, the last one the sequence) this rank keeps: its sequence
    shard under sequence parallelism, every row else.  None, and off such
    a split, the whole matrix.  ``stats`` ({"act", "w"}) passes the
    statistics in."""
    lead = tuple(int(d) for d in (lead if lead is not None else (x.shape[0],)))
    return _QuantizedMatmul.apply(x, w, QuantMode(mode), backend, role, lead, stats)


# ---------------------------------------------------------------------------
# lowbit_matmul — the low-bit integer core on unpacked ±1/0 matrices
# ---------------------------------------------------------------------------

def lowbit_matmul(a: torch.Tensor, b: torch.Tensor, mode: QuantMode, *,
                  backend: str = DEFAULT_BACKEND) -> torch.Tensor:
    """Exact integer matmul of {-1,0,1}-valued dense matrices a (m, k),
    b (k, n) through the packed pipeline -> int32 (m, n) (test/bench
    entry; no scales)."""
    k = a.shape[-1]
    bt = b.t()
    if mode == QuantMode.BNN:
        xa = {"bits": encoding.pack_binary(a)}
        wb = {"bits": encoding.pack_binary(bt)}
    elif mode == QuantMode.TNN:
        p, m_ = encoding.pack_ternary(a)
        wp, wm = encoding.pack_ternary(bt)
        xa = {"plus": p, "minus": m_}
        wb = {"plus": wp, "minus": wm}
    elif mode == QuantMode.TBN:
        p, m_ = encoding.pack_ternary(a)
        xa = {"plus": p, "minus": m_}
        wb = {"bits": encoding.pack_binary(bt)}
    else:
        raise ValueError(mode)
    qt = QTensor(payload=wb, scale=None, mode=mode,
                 shape=(int(k), int(b.shape[-1])))
    return packed_matmul(xa, qt, backend=backend)
