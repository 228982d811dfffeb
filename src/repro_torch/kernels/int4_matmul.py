"""u4 matmul over nibble-packed operands, the paper's U4 baseline: the
Hopper kernel ``csrc/affine_gemm.cu`` (u4 entry) and its plain PyTorch
version.

Counterpart of ``repro/kernels/int4_matmul.py`` (``int4_matmul_pallas``,
``pack_nibbles_rows``, ``pack_nibbles_cols``).  Packing: element 2t sits
in the low nibble, 2t+1 in the high nibble; A packs along its k axis
(axis 1), B along its k axis (axis 0); an odd k pads a 0 on both sides,
which adds nothing to the product.

The kernel reads each packed byte once and splits the nibbles in
registers (B while staging it, A as it feeds the u8 tensor-core
products); the plain version unpacks with shifts and masks and takes the
exact float64 product of ``int8_matmul.exact_int_matmul``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels._matmul_common import runs_kernel
from repro_torch.kernels.int8_matmul import affine_gemm_call, exact_int_matmul

__all__ = ["pack_nibbles_rows", "pack_nibbles_cols", "int4_matmul_cuda",
           "int4_matmul_torch"]


def pack_nibbles_rows(a_q: torch.Tensor) -> torch.Tensor:
    """(m, k) u4-valued -> (m, ceil(k/2)) uint8, k padded to even."""
    m, k = a_q.shape
    v = a_q.to(torch.uint8)
    if k % 2:
        v = F.pad(v, (0, 1))
    v = v.reshape(m, -1, 2)
    return v[..., 0] | (v[..., 1] << 4)


def pack_nibbles_cols(b_q: torch.Tensor) -> torch.Tensor:
    """(k, n) u4-valued -> (ceil(k/2), n) uint8, k padded to even."""
    k, n = b_q.shape
    v = b_q.to(torch.uint8)
    if k % 2:
        v = F.pad(v, (0, 0, 0, 1))
    v = v.reshape(-1, 2, n)
    return v[:, 0, :] | (v[:, 1, :] << 4)


def _unpack_rows(packed: torch.Tensor) -> torch.Tensor:     # (m, k2) -> (m, 2 k2)
    return torch.stack([packed & 0xF, packed >> 4], dim=-1).reshape(packed.shape[0], -1)


def _unpack_cols(packed: torch.Tensor) -> torch.Tensor:     # (k2, n) -> (2 k2, n)
    return torch.stack([packed & 0xF, packed >> 4], dim=1).reshape(-1, packed.shape[1])


def int4_matmul_torch(a_packed: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """Plain raw accumulator of nibble-packed operands: int32 (m, n)."""
    return exact_int_matmul(_unpack_rows(a_packed), _unpack_cols(b_packed))


def int4_matmul_cuda(a_packed: torch.Tensor, b_packed: torch.Tensor,
                     tile: Optional[int] = None) -> torch.Tensor:
    """Raw accumulator, int32 (m, n): the kernel on CUDA operands (in CTA
    tile ``tile``), the plain version on CPU operands."""
    if not runs_kernel(a_packed, b_packed):
        return int4_matmul_torch(a_packed, b_packed)
    return affine_gemm_call(True, a_packed, b_packed, 2 * a_packed.shape[1], tile)
