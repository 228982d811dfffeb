"""u8 (gemmlowp-style) matmul, the paper's U8 baseline: the Hopper kernel
``csrc/affine_gemm.cu`` and its plain PyTorch version.

Counterpart of ``repro/kernels/int8_matmul.py`` (``int8_matmul_pallas``):
the raw accumulator ``A_q @ B_q`` in int32, the first term of eq. (3).
The zero-point terms are rank-1 and are applied outside the kernel
(``ops._affine_core``), as the reference applies them outside Pallas.

The operands are **unsigned**: a (m, k) and b (k, n) ``torch.uint8``
holding 0..255.  An int8 cast would wrap 128..255, which is why
``torch._int_mm`` (signed int8 only) cannot compute this product.

``int8_matmul_cuda`` launches the kernel on CUDA tensors (or raises) and
runs ``int8_matmul_torch`` on CPU tensors.  The plain version is one
float64 product: exact while ``k * 255**2 < 2**53``, on the CPU and on
the card alike, so ``chip_smoke.py`` can compare at full size.  Both
wrap modulo 2**32 past the int32 range, as XLA's int32 dot does.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._matmul_common import AFFINE_TILES, cta_tile, runs_kernel

__all__ = ["int8_matmul_cuda", "int8_matmul_torch", "exact_int_matmul",
           "affine_gemm_call"]


def exact_int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) x (k, n) non-negative integer tensors -> int32 (m, n), exact
    through a float64 product while ``k * max(a) * max(b) < 2**53``;
    wraps modulo 2**32 past the int32 range."""
    acc = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    return acc.to(torch.int64).to(torch.int32)


def int8_matmul_torch(a_u8: torch.Tensor, b_u8: torch.Tensor) -> torch.Tensor:
    """Plain raw accumulator of u8 operands: int32 (m, n)."""
    return exact_int_matmul(a_u8, b_u8)


_KEYS = {False: "affine_gemm_u8", True: "affine_gemm_u4"}


def affine_gemm_call(u4: bool, a: torch.Tensor, b: torch.Tensor,
                     k: int, tile: Optional[int] = None) -> torch.Tensor:
    """Launch ``csrc/affine_gemm.cu`` on CUDA uint8 operands: u8 a (m, k),
    b (k, n), or nibble-packed a (m, k/2), b (k/2, n) with ``k`` even, in
    the CTA tile ``tile`` or, without one, the tile ``gemm_tile`` plans
    over ``AFFINE_TILES`` (``_matmul_common.cta_tile``; the
    launcher picks the widest copy the operands' addresses and row strides
    allow).  Raises on anything the kernel does not take; never falls
    back."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.uint8 or t.ndim != 2 or not t.is_contiguous():
            raise TypeError(f"{name}: expected a contiguous 2-D torch.uint8 "
                            f"tensor, got {t.dtype} {tuple(t.shape)}")
    device = a.get_device()
    if (device < 0 and not a.is_meta) or b.get_device() != device:
        raise ValueError(f"affine GeMM kernel needs CUDA operands on one "
                         f"device, got {a.device} and {b.device}")
    m, ka = a.shape
    kb, n = b.shape
    if ka != kb or k != (2 * ka if u4 else ka):
        raise ValueError(f"depth mismatch: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, k={k}")
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0 or k == 0:
        return out.zero_()
    if out.is_meta:
        _build.record(_KEYS[u4], m=m, n=n, k=k)
        return out
    _build.launch("affine_gemm_launch", _KEYS[u4], device, int(u4),
                  a.data_ptr(), b.data_ptr(), m, n, k,
                  cta_tile(tile, m, n, device, AFFINE_TILES), out.data_ptr())
    return out


def int8_matmul_cuda(a_u8: torch.Tensor, b_u8: torch.Tensor,
                     tile: Optional[int] = None) -> torch.Tensor:
    """Raw accumulator, int32 (m, n): the kernel on CUDA operands (in CTA
    tile ``tile``), the plain version on CPU operands."""
    if not runs_kernel(a_u8, b_u8):
        return int8_matmul_torch(a_u8, b_u8)
    return affine_gemm_call(False, a_u8, b_u8, a_u8.shape[1], tile)
