"""GeMM-based convolution — the paper's CNN deployment path (§I, §II).

Counterpart of ``repro/core/conv.py``.  ``im2col`` unrolls an NHWC
feature map so a conv becomes C = A @ B with A the (B*OH*OW, kh*kw*Cin)
patches and B the (kh*kw*Cin, Cout) filters, column order (dy, dx, c).

* ``pack_conv_filters`` + ``conv2d_packed`` — deployment: filters are
  packed once into a :class:`QTensor` carrying the conv ``geometry``;
  each call runs the implicit-im2col kernel (``ops.qconv``).
  ``fused=False`` runs the materializing oracle instead — im2col + one
  ``ops.qmm`` with the same ``conv_act_stats`` scalars, bit-identical.
* ``conv2d_quantized`` — the reference's QAT conv: the float modes are
  im2col + a float32 matrix product (the CNN's first layer), the
  quantized modes im2col + ``ops.quantized_matmul`` (filters packed per
  call, ``qmm`` forward, straight-through gradients).

Float products here run in full float32: TF32 is switched off for CUDA
matrix products (``torch.backends.cuda.matmul.allow_tf32 = False``), as
the reference's float32 ``jnp.dot`` rounds.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import quantize
from repro_torch.kernels import ops
from repro_torch.kernels.conv_fused import conv_act_stats, conv_spatial_pad
from repro_torch.kernels.modes import DEFAULT_BACKEND, QuantMode
from repro_torch.kernels.qtensor import QTensor

__all__ = ["im2col", "conv2d_quantized", "check_conv_depth",
           "pack_conv_filters", "conv2d_packed", "matmul_f32"]


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Float32 matrix product with TF32 off: the float layers (the first
    conv, the classifier) are plain products, not kernels of the port."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: str = "SAME") -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """x (B, H, W, C) -> (B*OH*OW, kh*kw*C), plus (B, OH, OW); padding
    from ``conv_fused.conv_spatial_pad``, the kernels' own helper."""
    b, _, _, c = x.shape
    x, (oh, ow) = conv_spatial_pad(x, kh, kw, stride, padding)
    cols = [x[:, dy:dy + (oh - 1) * stride + 1:stride,
              dx:dx + (ow - 1) * stride + 1:stride, :]
            for dy in range(kh) for dx in range(kw)]
    patches = torch.cat(cols, dim=-1)                 # (B, OH, OW, kh*kw*C)
    return patches.reshape(b * oh * ow, kh * kw * c), (b, oh, ow)


def check_conv_depth(c_in: int, kh: int, kw: int, *, accum_bits: int = 16,
                     lowbit: bool = True) -> None:
    """Raise if the GeMM depth would overflow the paper's accumulator
    (eq. (4)-(5))."""
    kmax = quantize.k_max(1 if lowbit else 8, accum_bits, signed_unit=lowbit)
    if c_in * kh * kw > kmax:
        raise ValueError(
            f"conv depth {c_in}*{kh}*{kw} = {c_in * kh * kw} exceeds "
            f"k_max={kmax} for {accum_bits}-bit accumulation (paper eq. (5))")


def conv2d_quantized(x: torch.Tensor, filters: torch.Tensor,
                     mode: QuantMode = QuantMode.TNN, *,
                     stride: int = 1, padding: str = "SAME",
                     backend: str = DEFAULT_BACKEND,
                     paper_accum_i16: bool = False) -> torch.Tensor:
    """Quantized conv: x (B,H,W,Cin), filters (kh,kw,Cin,Cout) float
    master weights -> (B, OH, OW, Cout) float32; differentiable in both
    (im2col + the STE quantized GeMM)."""
    kh, kw, cin, cout = filters.shape
    if paper_accum_i16 and mode.is_lowbit:
        check_conv_depth(cin, kh, kw)
    a, (b, oh, ow) = im2col(x, kh, kw, stride, padding)
    w2 = filters.reshape(kh * kw * cin, cout)
    if mode.is_float:
        y = matmul_f32(a, w2)
    else:
        y = ops.quantized_matmul(a, w2, mode, backend)
    return y.reshape(b, oh, ow, cout)


def pack_conv_filters(filters: torch.Tensor, mode: QuantMode,
                      bias: Optional[torch.Tensor] = None) -> QTensor:
    """Offline filter packing: (kh, kw, cin, cout) float -> QTensor with
    ``geometry`` (kh, kw, cin, cout), on ``filters``' device."""
    if not mode.is_lowbit:
        raise ValueError(f"pack_conv_filters only handles low-bit modes, "
                         f"got {mode}")
    kh, kw, cin, cout = filters.shape
    w2 = filters.reshape(kh * kw * cin, cout).to(torch.float32)
    return QTensor.from_dense(w2, mode, bias=bias,
                              geometry=(kh, kw, cin, cout))


def conv2d_packed(x: torch.Tensor, packed: QTensor, *,
                  stride: int = 1, padding: str = "SAME",
                  backend: str = DEFAULT_BACKEND,
                  paper_accum_i16: bool = False,
                  fused: Optional[bool] = None) -> torch.Tensor:
    """Deployment conv with filters from :func:`pack_conv_filters`.

    ``fused=None`` runs the implicit-im2col kernel whenever one is
    registered for (mode, backend); ``fused=False`` runs the
    materializing oracle (im2col + one ``ops.qmm`` with the shared
    ``conv_act_stats``), bit-identical to it.
    """
    if packed.geometry is None:
        raise ValueError("conv2d_packed needs a QTensor packed with "
                         "pack_conv_filters (geometry missing)")
    kh, kw, cin, cout = packed.geometry
    if paper_accum_i16:
        check_conv_depth(cin, kh, kw)
    if fused is None:
        fused = packed.is_lowbit and ops.has_conv_kernel(packed.mode, backend)
    if fused:
        y = ops.qconv(x, packed, stride=stride, padding=padding,
                      backend=backend)
        return y.to(x.dtype)
    x32 = x.to(torch.float32)
    stats = conv_act_stats(x32, packed.mode, kh, kw, stride, padding)
    a, (b, oh, ow) = im2col(x32, kh, kw, stride, padding)
    y = ops.qmm(a, packed, backend=backend, act_stats=stats)
    return y.reshape(b, oh, ow, cout).to(x.dtype)
