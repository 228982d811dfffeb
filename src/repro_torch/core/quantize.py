"""Quantizers and overflow guards (paper §II-B, eq. (1)-(5)) in PyTorch.

Counterpart of ``repro/core/quantize.py``: affine (u8/u4) quantization,
the sign / TWN threshold quantizers for binary and ternary values, and
the accumulator-overflow depth bound ``k_max`` of eq. (4) with the conv
input-channel bound of eq. (5).

As in the reference, eq. (1) is implemented sign-corrected:
``x_hat = clamp(round(x/s) + z, 0, Q)``.  ``torch.round`` rounds half to
even, as ``jnp.round`` does.

Means are written as ``sum / n`` with ``n`` a device tensor: that is how
``jnp.mean`` divides, whereas ``Tensor.mean`` and division by a Python
scalar on a CUDA tensor multiply by a reciprocal and can land one ULP
away.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = [
    "f32_scalar",
    "AffineQuant",
    "affine_calibrate",
    "affine_from_range",
    "affine_quantize",
    "affine_dequantize",
    "binarize",
    "ternarize",
    "ternary_threshold",
    "mean_abs",
    "k_max",
    "max_conv_in_channels",
    "ACCUM_BITS_PAPER",
]

# The paper accumulates TNN/TBN/BNN products in signed 16-bit lanes.
ACCUM_BITS_PAPER = 16


def f32_scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on ``like``'s device, made by a fill there: no
    host-to-device copy, so no stream sync."""
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def mean_abs(x: torch.Tensor, dim: Optional[int] = None,
             keepdim: bool = False) -> torch.Tensor:
    """mean |x| as ``sum / n`` (see the module note on division)."""
    a = x.abs()
    if dim is None:
        return a.sum() / f32_scalar(a.numel(), a)
    return a.sum(dim=dim, keepdim=keepdim) / f32_scalar(a.shape[dim], a)


@dataclasses.dataclass(frozen=True)
class AffineQuant:
    """scale / zero-point pair for n-bit affine quantization."""
    scale: torch.Tensor        # f32 scalar (per-tensor) or (n,) per-channel
    zero_point: torch.Tensor   # int32, same rank as scale
    bits: int

    @property
    def qmax(self) -> int:
        return (1 << self.bits) - 1


def affine_calibrate(x: torch.Tensor, bits: int, *, axis=None) -> AffineQuant:
    """Min/max calibration: choose (s, z) so [min(x), max(x)] maps onto
    [0, 2^bits - 1], always covering 0 (gemmlowp convention)."""
    x = x.float()
    mn = x.amin() if axis is None else x.amin(dim=axis)
    mx = x.amax() if axis is None else x.amax(dim=axis)
    return affine_from_range(mn, mx, bits)


def affine_from_range(mn: torch.Tensor, mx: torch.Tensor, bits: int) -> AffineQuant:
    """The (s, z) of :func:`affine_calibrate` from the range's float32
    ``mn`` and ``mx`` (a split batch reduces them over its ranks first)."""
    qmax = (1 << bits) - 1
    x = mn
    lo = mn.clamp(max=0.0)
    hi = mx.clamp(min=0.0)
    scale = (hi - lo).clamp(min=1e-8) / f32_scalar(qmax, x)
    zero_point = torch.round(-lo / scale).clamp(0, qmax).to(torch.int32)
    return AffineQuant(scale=scale, zero_point=zero_point, bits=bits)


def affine_quantize(x: torch.Tensor, q: AffineQuant) -> torch.Tensor:
    """eq. (1) (sign-corrected): x_hat = clamp(round(x/s) + z, 0, Q)."""
    v = torch.round(x / q.scale) + q.zero_point
    return v.clamp(0, q.qmax).to(torch.int32)


def affine_dequantize(x_hat: torch.Tensor, q: AffineQuant) -> torch.Tensor:
    return (x_hat.float() - q.zero_point) * q.scale


# ---------------------------------------------------------------------------
# Binary / ternary quantizers
# ---------------------------------------------------------------------------

def binarize(x: torch.Tensor):
    """XNOR-Net-style binarization: sign(x) with one fp scale
    alpha = mean|x|.  Returns (b in {-1,+1} float32, alpha scalar)."""
    alpha = mean_abs(x)
    b = torch.where(x < 0, -1.0, 1.0).to(torch.float32)
    return b, alpha


def ternary_threshold(x: torch.Tensor) -> torch.Tensor:
    """TWN heuristic threshold: 0.7 * mean|x|."""
    return 0.7 * mean_abs(x)


def ternarize(x: torch.Tensor, threshold: Optional[torch.Tensor] = None):
    """Ternary-Weight-Network quantizer: t = sign(x) * 1[|x| > thr], with
    fp scale alpha = E[|x| ; |x| > thr].  Returns (t, alpha)."""
    thr = ternary_threshold(x) if threshold is None else threshold
    mask = x.abs() > thr
    t = torch.sign(x) * mask
    denom = mask.sum().clamp(min=1).to(torch.float32)
    alpha = (x.abs() * mask).sum() / denom
    return t.to(torch.float32), alpha


# ---------------------------------------------------------------------------
# Overflow guards — eq. (4), (5)
# ---------------------------------------------------------------------------

def k_max(p_bits: int, q_bits: int = ACCUM_BITS_PAPER, *,
          signed_unit: bool = False) -> int:
    """Maximum reduction depth with no accumulator overflow, eq. (4):
    ``k_max = floor((2^q - 1) / (2^p - 1)^2)`` for p-bit operands in
    q-bit registers; for {-1, 0, 1} products (``signed_unit=True``) the
    largest magnitude a signed q-bit register holds, 2^(q-1) - 1."""
    if signed_unit:
        return (1 << (q_bits - 1)) - 1
    return ((1 << q_bits) - 1) // (((1 << p_bits) - 1) ** 2)


def max_conv_in_channels(kmax: int, kernel_h: int, kernel_w: int) -> int:
    """eq. (5): the deepest GeMM a conv can produce is C_in * Hk * Wk."""
    return kmax // (kernel_h * kernel_w)
