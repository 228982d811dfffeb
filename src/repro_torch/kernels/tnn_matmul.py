"""TNN GeMM, ternary activations x ternary weights; the Hopper kernel ``csrc/lowbit_gemm.cu``
instantiated for tnn and its plain PyTorch version.

Counterpart of ``repro/kernels/tnn_matmul.py``
(``tnn_matmul_pallas`` / ``tnn_matmul_fused_pallas``) and of the
reference's XLA versions ``ops.tnn_matmul_xla[_fused]``:

    z+ = (a+ & b+) | (a- & b-);  z- = (a+ & b-) | (a- & b+)
    acc = sum popcount(z+) - popcount(z-)                          (eq. 7)

Pad words are (0,0) == ternary zero, so no depth correction is needed.

``tnn_matmul_cuda`` / ``tnn_matmul_fused_cuda`` take the planes as
int32 tensors holding uint32 bits: on CUDA tensors they launch the kernel
or raise, on CPU tensors they run ``tnn_matmul_torch`` /
``tnn_matmul_fused_torch``.  The fused form applies eq. (2),
``acc * row_scale * col_scale (+ bias)``, and is exact in float32: every
count is an integer of magnitude at most k_valid < 2**24.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._matmul_common import (
    DEFAULT_TILES,
    PRODUCT_FNS,
    chunked_bitwise_matmul,
    lowbit_matmul_call,
    runs_kernel,
    scale_epilogue,
)
from repro_torch.kernels.modes import QuantMode

_MODE = QuantMode.TNN
_TILES = DEFAULT_TILES["tnn"]

__all__ = ["tnn_matmul_cuda", "tnn_matmul_fused_cuda",
           "tnn_matmul_torch", "tnn_matmul_fused_torch"]


def tnn_matmul_torch(a_plus: torch.Tensor, a_minus: torch.Tensor,
                     b_plus_t: torch.Tensor, b_minus_t: torch.Tensor,
                     k_valid: int = 0, *,
                     word_chunk: int = _TILES.word_chunk) -> torch.Tensor:
    """Plain int32 core (m, n)."""
    return chunked_bitwise_matmul(PRODUCT_FNS[_MODE], [a_plus, a_minus],
                                  [b_plus_t, b_minus_t], word_chunk=word_chunk)


def tnn_matmul_fused_torch(a_plus: torch.Tensor, a_minus: torch.Tensor,
                           b_plus_t: torch.Tensor, b_minus_t: torch.Tensor,
                           k_valid: int, row_scale: torch.Tensor,
                           col_scale: torch.Tensor,
                           bias: Optional[torch.Tensor] = None, *,
                           word_chunk: int = _TILES.word_chunk) -> torch.Tensor:
    """Plain fused form: float32 (m, n); row_scale (m, 1) or one value,
    col_scale and bias (1, n)."""
    def epi(acc):
        return scale_epilogue(acc, row_scale, col_scale, bias)
    return chunked_bitwise_matmul(PRODUCT_FNS[_MODE], [a_plus, a_minus],
                                  [b_plus_t, b_minus_t], word_chunk=word_chunk,
                                  epilogue=epi)


def tnn_matmul_cuda(a_plus: torch.Tensor, a_minus: torch.Tensor,
                    b_plus_t: torch.Tensor, b_minus_t: torch.Tensor,
                    k_valid: int = 0, tile: Optional[int] = None) -> torch.Tensor:
    """int32 core (m, n): the kernel on CUDA planes, the plain version on
    CPU planes.  ``tile``: the CTA tile (``_matmul_common.cta_tile``)."""
    if not runs_kernel(a_plus, a_minus, b_plus_t, b_minus_t):
        return tnn_matmul_torch(a_plus, a_minus, b_plus_t, b_minus_t, k_valid)
    return lowbit_matmul_call(_MODE, (a_plus, a_minus), (b_plus_t, b_minus_t), k_valid,
                              tile=tile)


def tnn_matmul_fused_cuda(a_plus: torch.Tensor, a_minus: torch.Tensor,
                          b_plus_t: torch.Tensor, b_minus_t: torch.Tensor,
                          k_valid: int, row_scale: torch.Tensor,
                          col_scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          tile: Optional[int] = None) -> torch.Tensor:
    """Fused form, float32 (m, n): the kernel on CUDA operands, the plain
    version on CPU operands.  ``tile``: the CTA tile
    (``_matmul_common.cta_tile``)."""
    if not runs_kernel(a_plus, a_minus, b_plus_t, b_minus_t, row_scale, col_scale,
                       bias):
        return tnn_matmul_fused_torch(a_plus, a_minus, b_plus_t, b_minus_t, k_valid,
                                      row_scale, col_scale, bias)
    return lowbit_matmul_call(
        _MODE, (a_plus, a_minus), (b_plus_t, b_minus_t), k_valid,
        row_scale=row_scale, col_scale=col_scale, bias=bias, tile=tile)
