"""Public entry points of the low-bit kernels: ``pack_weights``, ``qmm``,
``qconv``.

Counterpart of the GeMM and conv half of ``repro/kernels/ops.py``:

* ``pack_weights(w, mode)`` (== :meth:`QTensor.from_dense`) — offline
  packing, the paper's Algorithm 2 PackedB;
* ``qmm(x, qt)`` — float activations x packed weights -> float32:
  ternarize/binarize -> pack -> popcount GeMM -> eq. (2) epilogue, the
  last two in one kernel launch on the card;
* ``qconv(x, qt)`` — the same through the implicit-im2col conv kernel;
* ``packed_matmul(xa, qt)`` — the int32 core alone.

Kernels are chosen through :mod:`repro_torch.kernels.registry`; the
backend ``"cuda"`` (the default) launches the Hopper kernels on CUDA
tensors and runs their plain versions on CPU tensors, ``"torch"`` runs
the plain versions anywhere.  A failing launch raises: there is no
fallback chain.

Not ported in this slice (see ROADMAP.md): the plan cache and tuner
(tiles are ``DEFAULT_TILES``), the obs counters and fault-injection
points, the fallback chain, the mesh branch, the affine u8/u4 cells, the
float passthrough of ``qmm`` and ``quantized_matmul`` with its STE
backward.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import encoding, quantize
from repro_torch.kernels import conv_fused, registry
from repro_torch.kernels import ref as kref
from repro_torch.kernels._matmul_common import (
    DEFAULT_TILES, TileConfig, scale_epilogue)
from repro_torch.kernels.bnn_matmul import (
    bnn_matmul_cuda, bnn_matmul_fused_cuda, bnn_matmul_fused_torch,
    bnn_matmul_torch)
from repro_torch.kernels.modes import DEFAULT_BACKEND, QuantMode
from repro_torch.kernels.qtensor import PAYLOAD_KEYS, QTensor
from repro_torch.kernels.tbn_matmul import (
    tbn_matmul_cuda, tbn_matmul_fused_cuda, tbn_matmul_fused_torch,
    tbn_matmul_torch)
from repro_torch.kernels.tnn_matmul import (
    tnn_matmul_cuda, tnn_matmul_fused_cuda, tnn_matmul_fused_torch,
    tnn_matmul_torch)

__all__ = ["QuantMode", "QTensor", "qmm", "qconv", "pack_weights",
           "quantize_activations", "packed_matmul", "has_conv_kernel",
           "DEFAULT_BACKEND"]

# Planes each mode consumes on the ACTIVATION side (weights use
# qtensor.PAYLOAD_KEYS); TBN is ternary activations x binary weights.
_A_KEYS: Dict[QuantMode, Tuple[str, ...]] = {
    QuantMode.BNN: ("bits",),
    QuantMode.TNN: ("plus", "minus"),
    QuantMode.TBN: ("plus", "minus"),
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
                return {}    # the CUDA tiles are compiled in
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
            description=("chunked popcount in plain PyTorch" if plain else
                         "csrc/lowbit_gemm.cu, int32 registers")
                        + ("; eq. (2) epilogue" if fused else ""),
        )(make(mode, kernel, fused, plain))


_register_all_kernels()


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

def pack_weights(w: torch.Tensor, mode: QuantMode, *,
                 per_channel: bool = True) -> QTensor:
    """Offline weight packing (Algorithm 2's PackedB): (k, n) float ->
    :class:`QTensor` on ``w``'s device."""
    return QTensor.from_dense(w, mode, per_channel=per_channel)


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
    packed planes plus the per-tensor ``scale``.

    ``stats`` optionally supplies the per-tensor statistics ({"thr",
    "scale"} for ternary modes, {"scale"} for BNN) instead of deriving
    them from ``x`` — the conv oracle passes ``conv_act_stats`` here.
    """
    if not mode.is_lowbit:
        raise ValueError(f"quantize_activations: {mode.value} is not ported "
                         f"(low-bit modes only)")
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
    return tuple(wb.payload[k] for k in PAYLOAD_KEYS[mode])


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
    return spec.fn(a_pl, _b_planes(wb, mode), wb.k_valid)


# ---------------------------------------------------------------------------
# qmm — float x QTensor -> float32
# ---------------------------------------------------------------------------

def _as_row_scale(scale, m: int, like: torch.Tensor) -> torch.Tensor:
    """Activation scale (scalar or (m,)) -> (m, 1) float32."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=like.device)
    if s.ndim == 0:
        return s.reshape(1, 1).expand(m, 1)
    return s.reshape(m, 1)


def _as_col_vec(v, n: int, like: torch.Tensor) -> torch.Tensor:
    """Weight scale / bias (scalar or (n,)) -> (1, n) float32."""
    x = torch.as_tensor(v, dtype=torch.float32, device=like.device)
    if x.ndim == 0:
        return x.reshape(1, 1).expand(1, n)
    return x.reshape(1, n)


def _check_lowbit(qt: QTensor, what: str) -> None:
    if not isinstance(qt, QTensor):
        raise TypeError(f"{what} expects a QTensor, got {type(qt).__name__}")
    if not qt.is_lowbit:
        raise ValueError(f"{what}: mode {qt.mode.value} is not ported (the "
                         f"float passthrough and affine u8/u4 cells come "
                         f"with a later slice); low-bit modes only")


def qmm(x: torch.Tensor, qt: QTensor, *, backend: Optional[str] = None,
        act_stats: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Quantized matmul: float ``x`` (m, k) against a low-bit
    :class:`QTensor` -> float32 (m, n).

    Quantize and pack ``x`` (per-tensor TWN / mean-abs statistics, or
    ``act_stats``), then one fused kernel: popcount core + eq. (2)
    ``acc * row_scale * col_scale (+ bias)``.  ``backend`` None ->
    :data:`DEFAULT_BACKEND` ("cuda"); the device is ``x``'s, and
    ``qt`` must lie on it.
    """
    _check_lowbit(qt, "qmm")
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
    xa = quantize_activations(x.to(torch.float32), mode, stats=act_stats)
    row = _as_row_scale(xa["scale"], m, x)
    col = _as_col_vec(qt.scale, n, x)
    b2 = None if qt.bias is None else _as_col_vec(qt.bias, n, x)
    spec = registry.lookup(mode, backend, fused=True)
    a_pl = tuple(xa[kk] for kk in _A_KEYS[mode])
    return spec.fn(a_pl, _b_planes(qt, mode), k, row, col, b2)


def _dense_values(planes, k: int, ternary: bool) -> torch.Tensor:
    if ternary:
        return encoding.unpack_ternary(planes[0], planes[1], k)
    return encoding.unpack_binary(planes[0], k)


def _qmm_oracle(x: torch.Tensor, qt: QTensor,
                act_stats: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Materializing oracle (counterpart of ``_qmm_oracle_jit``): unpack
    both operands to ±1/0 values, exact integer product, then the eq. (2)
    epilogue in plain torch — for the tests, small shapes only."""
    _check_lowbit(qt, "qmm oracle")
    m, k = x.shape
    mode = qt.mode
    xa = quantize_activations(x.to(torch.float32), mode, stats=act_stats)
    av = _dense_values([xa[kk] for kk in _A_KEYS[mode]], k,
                       ternary=mode != QuantMode.BNN)
    bv = _dense_values(_b_planes(qt, mode), k, ternary=mode == QuantMode.TNN)
    acc = kref.bnn_matmul_dense_ref(av, bv.t())
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
    materializing oracle (im2col + :func:`qmm` with the same stats)."""
    _check_lowbit(qt, "qconv")
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
    x = x.to(torch.float32).contiguous()
    if act_stats is None:
        stats = conv_fused.conv_act_stats(x, qt.mode, kh, kw_, stride, padding)
    else:
        stats = {k: _stat(v, x) for k, v in act_stats.items()}
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
