"""BNN GeMM, binary activations x binary weights; the Hopper kernel ``csrc/lowbit_gemm.cu``
instantiated for bnn and its plain PyTorch version.

Counterpart of ``repro/kernels/bnn_matmul.py``
(``bnn_matmul_pallas`` / ``bnn_matmul_fused_pallas``) and of the
reference's XLA versions ``ops.bnn_matmul_xla[_fused]``:

    c = k_valid - 2 * sum popcount(a XOR b)                        (eq. 6)

Pad bits are 0 (value +1) on both operands, so they XOR to 0 and eq. (6)
with the true depth stays exact.

``bnn_matmul_cuda`` / ``bnn_matmul_fused_cuda`` take the planes as
int32 tensors holding uint32 bits: on CUDA tensors they launch the kernel
or raise, on CPU tensors they run ``bnn_matmul_torch`` /
``bnn_matmul_fused_torch``.  The fused form applies eq. (2),
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

_MODE = QuantMode.BNN
_TILES = DEFAULT_TILES["bnn"]

__all__ = ["bnn_matmul_cuda", "bnn_matmul_fused_cuda",
           "bnn_matmul_torch", "bnn_matmul_fused_torch"]


def bnn_matmul_torch(a_bits: torch.Tensor, b_bits_t: torch.Tensor,
                     k_valid: int, *,
                     word_chunk: int = _TILES.word_chunk) -> torch.Tensor:
    """Plain int32 core (m, n)."""
    acc = chunked_bitwise_matmul(PRODUCT_FNS[_MODE], [a_bits], [b_bits_t],
                                 word_chunk=word_chunk)
    return k_valid - 2 * acc


def bnn_matmul_fused_torch(a_bits: torch.Tensor, b_bits_t: torch.Tensor,
                           k_valid: int, row_scale: torch.Tensor,
                           col_scale: torch.Tensor,
                           bias: Optional[torch.Tensor] = None, *,
                           word_chunk: int = _TILES.word_chunk) -> torch.Tensor:
    """Plain fused form: float32 (m, n); row_scale (m, 1), col_scale and
    bias (1, n)."""
    def epi(acc):
        return scale_epilogue(k_valid - 2 * acc, row_scale, col_scale, bias)
    return chunked_bitwise_matmul(PRODUCT_FNS[_MODE], [a_bits], [b_bits_t],
                                  word_chunk=word_chunk, epilogue=epi)


def bnn_matmul_cuda(a_bits: torch.Tensor, b_bits_t: torch.Tensor,
                    k_valid: int) -> torch.Tensor:
    """int32 core (m, n): the kernel on CUDA planes, the plain version on
    CPU planes."""
    if not on_cuda(a_bits, b_bits_t):
        return bnn_matmul_torch(a_bits, b_bits_t, k_valid)
    return lowbit_matmul_call(_MODE, (a_bits,), (b_bits_t,), k_valid)


def bnn_matmul_fused_cuda(a_bits: torch.Tensor, b_bits_t: torch.Tensor,
                          k_valid: int, row_scale: torch.Tensor,
                          col_scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused form, float32 (m, n): the kernel on CUDA operands, the plain
    version on CPU operands."""
    if not on_cuda(a_bits, b_bits_t, row_scale, col_scale, bias):
        return bnn_matmul_fused_torch(a_bits, b_bits_t, k_valid,
                                      row_scale, col_scale, bias)
    return lowbit_matmul_call(
        _MODE, (a_bits,), (b_bits_t,), k_valid,
        row_scale=row_scale.reshape(-1).contiguous(),
        col_scale=col_scale.reshape(-1).contiguous(),
        bias=None if bias is None else bias.reshape(-1).contiguous())
