"""Plain PyTorch oracles for every kernel of the port — the specification.

Counterpart of ``repro/kernels/ref.py``.  ``C = A @ B`` with A (m, k) and
B (k, n); packed operands pack the depth axis into 32-bit words held in
int32 tensors: A row-major as (m, kw), B **transposed** as (n, kw).
``k_valid`` is the true depth.

Simple and small-shape by design: the packed oracles broadcast the whole
(m, n, kw) product, the dense ones the whole (m, k, n) product.  The
tests hold the kernels' plain versions, and through them the kernels,
against these.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._matmul_common import popcount_i32

__all__ = [
    "matmul_f32_ref",
    "bnn_matmul_ref",
    "tnn_matmul_ref",
    "tbn_matmul_ref",
    "int8_matmul_ref",
    "int4_matmul_ref",
    "bnn_matmul_dense_ref",
    "tnn_matmul_dense_ref",
    "tbn_matmul_dense_ref",
]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) x (k, n) as a broadcast sum, exact for integer dtypes."""
    return (a[:, :, None] * b[None, :, :]).sum(dim=1)


def matmul_f32_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Float32 ``a @ b``, summed in float64 so that TF32 on the card does
    not round the operands (no process-wide flag is set)."""
    return torch.matmul(a.to(torch.float32).double(), b.to(torch.float32).double()).float()


# ---------------------------------------------------------------------------
# Dense-value oracles: {-1,0,1} matrices -> exact int32
# ---------------------------------------------------------------------------

def bnn_matmul_dense_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _dot(a.to(torch.int64), b.to(torch.int64)).to(torch.int32)


tnn_matmul_dense_ref = bnn_matmul_dense_ref
tbn_matmul_dense_ref = bnn_matmul_dense_ref


# ---------------------------------------------------------------------------
# Packed oracles
# ---------------------------------------------------------------------------

def bnn_matmul_ref(a_bits: torch.Tensor, b_bits_t: torch.Tensor,
                   k_valid: int) -> torch.Tensor:
    """Binary GeMM, eq. (6): c = k - 2 * sum_w popcount(a_w XOR b_w)."""
    x = a_bits[:, None, :] ^ b_bits_t[None, :, :]
    return k_valid - 2 * popcount_i32(x).sum(dim=-1, dtype=torch.int32)


def tnn_matmul_ref(a_plus, a_minus, b_plus_t, b_minus_t,
                   k_valid: int = 0) -> torch.Tensor:
    """Ternary GeMM, Table I + eq. (7) (k_valid unused: pads are 0)."""
    ap, am = a_plus[:, None, :], a_minus[:, None, :]
    bp, bm = b_plus_t[None, :, :], b_minus_t[None, :, :]
    acc = popcount_i32((ap & bp) | (am & bm)) - popcount_i32((ap & bm) | (am & bp))
    return acc.sum(dim=-1, dtype=torch.int32)


def tbn_matmul_ref(a_plus, a_minus, b_bits_t,
                   k_valid: int = 0) -> torch.Tensor:
    """Ternary x binary GeMM, Table I: z+ = (x+ | y) & (x- | ~y),
    z- = (x+ | ~y) & (x- | y)."""
    ap, am = a_plus[:, None, :], a_minus[:, None, :]
    bb = b_bits_t[None, :, :]
    nbb = ~bb
    acc = popcount_i32((ap | bb) & (am | nbb)) - popcount_i32((ap | nbb) & (am | bb))
    return acc.sum(dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# u8 / u4 baselines (gemmlowp-style, eq. (3))
# ---------------------------------------------------------------------------

def _affine_matmul_ref(a_q, b_q, za, zb, k_valid):
    """c~ = A_q B_q - zb * rowsum(A_q) - za * colsum(B_q) + k za zb."""
    a64, b64 = a_q.to(torch.int64), b_q.to(torch.int64)
    acc = _dot(a64, b64)
    rows = a64.sum(dim=1)
    cols = b64.sum(dim=0)
    za = torch.as_tensor(za, dtype=torch.int64)
    zb = torch.as_tensor(zb, dtype=torch.int64)
    out = acc - zb * rows[:, None] - za * cols[None, :] + k_valid * za * zb
    return out.to(torch.int32)


def int8_matmul_ref(a_q, b_q, za, zb, k_valid: int):
    """u8 x u8 -> i32 with zero-point correction (gemmlowp [29])."""
    return _affine_matmul_ref(a_q, b_q, za, zb, k_valid)


def int4_matmul_ref(a_q, b_q, za, zb, k_valid: int):
    """u4 x u4 -> i32 with zero-point correction."""
    return _affine_matmul_ref(a_q, b_q, za, zb, k_valid)
