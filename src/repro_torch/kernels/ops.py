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

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import encoding, quantize
from repro_torch.kernels import conv_fused, dense_fused, registry
from repro_torch.kernels import indexed_matmul as _indexed_matmul
from repro_torch.kernels._matmul_common import (
    DEFAULT_TILES, TileConfig, scale_epilogue)
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

__all__ = ["QuantMode", "QTensor", "qmm", "qconv", "pack_weights",
           "quantize_activations", "packed_matmul", "has_conv_kernel",
           "lowbit_matmul", "int8_affine_matmul", "int4_affine_matmul",
           "quantized_matmul", "DEFAULT_BACKEND"]

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
    return spec.fn(a_pl, _b_planes(qt, mode), k, row, col, b2, tiles=tiles, **extra)


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

def split_batch_stats(x: torch.Tensor, mode: QuantMode, split) -> Dict[str, Any]:
    """The per-tensor activation statistics of the global batch whose rows
    ``x`` (m, k) holds this rank's share of (``sharding.split_batch``):
    the same formulas as :func:`quantize_activations` derives from a whole
    ``x``, with every sum and count summed over the batch axes (float64
    partial sums, so the result is the exact sum rounded once to float32,
    a few ULPs from one device's float32 sum) and the affine range's
    min / max reduced exactly."""
    x = x.to(torch.float32)
    f64 = torch.float64
    if mode in (QuantMode.INT8, QuantMode.INT4):
        r = split.reduce(torch.stack([x.amax(), -x.amin()]), "max")
        q = quantize.affine_from_range(-r[1], r[0], 8 if mode == QuantMode.INT8 else 4)
        return {"scale": q.scale, "zero": q.zero_point}
    a = x.abs()
    tot = split.reduce(torch.stack([a.sum(dtype=f64),
                                    torch.full((), a.numel(), dtype=f64, device=a.device)]))
    mean = tot[0].to(torch.float32) / tot[1].to(torch.float32)
    if mode == QuantMode.BNN:
        return {"scale": mean}
    thr = 0.7 * mean
    mask = a > thr
    kept = split.reduce(torch.stack([(a * mask).sum(dtype=f64), mask.sum().to(f64)]))
    return {"thr": thr,
            "scale": kept[0].to(torch.float32) / kept[1].to(torch.float32).clamp(min=1)}


def _qmm_fwd_value(x: torch.Tensor, w: torch.Tensor, mode: QuantMode,
                   backend: str) -> torch.Tensor:
    """F32: a float32 product; BF16: bf16 operands, exact float32
    products and sums (never a bf16 ``torch.matmul``, which rounds its
    output to bf16); every quantized mode: ``qmm`` against ``w`` packed
    here (QAT re-packs per call; inference packs once and calls ``qmm``).
    When the batch is split over ranks (the training mesh), the
    activation statistics are the global batch's (:func:`split_batch_stats`)."""
    from repro_torch.core.conv import matmul_f32   # core.conv imports ops
    from repro_torch.parallel import sharding

    if mode == QuantMode.F32:
        return matmul_f32(x, w)
    if mode == QuantMode.BF16:
        return matmul_f32(x.to(torch.bfloat16), w.to(torch.bfloat16))
    split = sharding.batch_split()
    stats = None if split is None or not split.axes else split_batch_stats(x, mode, split)
    return qmm(x, QTensor.from_dense(w, mode), backend=backend, act_stats=stats)


class _QuantizedMatmul(torch.autograd.Function):
    """Straight-through at matmul granularity: the backward treats the
    whole pipeline as ``x @ w`` (reference ``ops._qmm_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, mode, backend):
        ctx.save_for_backward(x, w)
        ctx.mode = mode
        return _qmm_fwd_value(x, w, mode, backend)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.conv import matmul_f32

        x, w = ctx.saved_tensors
        g = g.to(torch.float32)
        gx = matmul_f32(g, w.t())
        gw = matmul_f32(x.t(), g)
        if ctx.mode.is_lowbit:
            gx = gx * (x.abs() <= 1.0)      # clip-range STE (hard tanh)
        return gx.to(x.dtype), gw.to(w.dtype), None, None


def quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                     mode: QuantMode = QuantMode.TNN,
                     backend: str = DEFAULT_BACKEND) -> torch.Tensor:
    """y ~= x @ w, x (m, k) and float master weights w (k, n) -> float32
    (m, n), computed through the selected quantized pipeline.

    Gradients are straight-through (standard for BNN/TNN QAT):
    ``gx = g @ w.T`` and ``gw = x.T @ g`` in float32, with a hard-tanh
    clip mask ``|x| <= 1`` on ``gx`` for the binary/ternary modes
    (XNOR-Net)."""
    return _QuantizedMatmul.apply(x, w, QuantMode(mode), backend)


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
