"""TBN GeMM, ternary activations x binary weights; the Hopper kernel ``csrc/lowbit_gemm.cu``
instantiated for tbn and its plain PyTorch version.

Counterpart of ``repro/kernels/tbn_matmul.py``
(``tbn_matmul_pallas`` / ``tbn_matmul_fused_pallas``) and of the
reference's XLA versions ``ops.tbn_matmul_xla[_fused]``:

    z+ = (a+ | b) & (a- | ~b);  z- = (a+ | ~b) & (a- | b)
    acc = sum popcount(z+) - popcount(z-)                          (Table I)

A's pad words are (0,0), which force z+ == z- == 0 whatever B holds, so
no depth correction is needed.

``tbn_matmul_cuda`` / ``tbn_matmul_fused_cuda`` take the planes as
int32 tensors holding uint32 bits: on CUDA tensors they launch the kernel
or raise, on CPU tensors they run ``tbn_matmul_torch`` /
``tbn_matmul_fused_torch``.  The fused form applies eq. (2),
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
    on_cuda,
    scale_epilogue,
)
from repro_torch.kernels.modes import QuantMode

_MODE = QuantMode.TBN
_TILES = DEFAULT_TILES["tbn"]

__all__ = ["tbn_matmul_cuda", "tbn_matmul_fused_cuda",
           "tbn_matmul_torch", "tbn_matmul_fused_torch"]


def tbn_matmul_torch(a_plus: torch.Tensor, a_minus: torch.Tensor,
                     b_bits_t: torch.Tensor,
                     k_valid: int = 0, *,
                     word_chunk: int = _TILES.word_chunk) -> torch.Tensor:
    """Plain int32 core (m, n)."""
    return chunked_bitwise_matmul(PRODUCT_FNS[_MODE], [a_plus, a_minus],
                                  [b_bits_t], word_chunk=word_chunk)


def tbn_matmul_fused_torch(a_plus: torch.Tensor, a_minus: torch.Tensor,
                           b_bits_t: torch.Tensor,
                           k_valid: int, row_scale: torch.Tensor,
                           col_scale: torch.Tensor,
                           bias: Optional[torch.Tensor] = None, *,
                           word_chunk: int = _TILES.word_chunk) -> torch.Tensor:
    """Plain fused form: float32 (m, n); row_scale (m, 1), col_scale and
    bias (1, n)."""
    def epi(acc):
        return scale_epilogue(acc, row_scale, col_scale, bias)
    return chunked_bitwise_matmul(PRODUCT_FNS[_MODE], [a_plus, a_minus],
                                  [b_bits_t], word_chunk=word_chunk,
                                  epilogue=epi)


def tbn_matmul_cuda(a_plus: torch.Tensor, a_minus: torch.Tensor,
                    b_bits_t: torch.Tensor,
                    k_valid: int = 0) -> torch.Tensor:
    """int32 core (m, n): the kernel on CUDA planes, the plain version on
    CPU planes."""
    if not on_cuda(a_plus, a_minus, b_bits_t):
        return tbn_matmul_torch(a_plus, a_minus, b_bits_t, k_valid)
    return lowbit_matmul_call(_MODE, (a_plus, a_minus), (b_bits_t,), k_valid)


def tbn_matmul_fused_cuda(a_plus: torch.Tensor, a_minus: torch.Tensor,
                          b_bits_t: torch.Tensor,
                          k_valid: int, row_scale: torch.Tensor,
                          col_scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused form, float32 (m, n): the kernel on CUDA operands, the plain
    version on CPU operands."""
    if not on_cuda(a_plus, a_minus, b_bits_t, row_scale, col_scale,
                   bias):
        return tbn_matmul_fused_torch(a_plus, a_minus, b_bits_t, k_valid,
                                      row_scale, col_scale, bias)
    return lowbit_matmul_call(
        _MODE, (a_plus, a_minus), (b_bits_t,), k_valid,
        row_scale=row_scale.reshape(-1).contiguous(),
        col_scale=col_scale.reshape(-1).contiguous(),
        bias=None if bias is None else bias.reshape(-1).contiguous())
