"""Shared plumbing of the low-bit GeMM: tiles, the popcount core's plain
PyTorch version, the eq. (2) epilogue, the operand checks every GeMM
wrapper makes, and the launcher of the Hopper kernel
``csrc/lowbit_gemm.cu``.

Counterpart of ``repro/kernels/_matmul_common.py``.  The reference runs
a sequential ``(m/bm, n/bn, kw/bkw)`` Pallas grid whose output tile stays
resident in VMEM across the k axis.  On Hopper the blocks run in
parallel and in no order, so each CTA owns a row block, stages its A
rows once and loops over its column blocks and the k words itself
(``lowbit_matmul_call`` below launches it, in the CTA tile
:func:`gemm_tile` chooses).

The plain version (:func:`chunked_bitwise_matmul`) is the counterpart of
the reference's k-chunked ``lax.scan`` (``ops._chunked_bitwise_matmul``):
rows and words are chunked so the ``(rows, n, word_chunk)`` intermediate
stays bounded, and torch has no popcount, so :func:`popcount_i32` is the
SWAR bit count on int64.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.modes import QuantMode

__all__ = ["TileConfig", "DEFAULT_TILES", "GEMM_TILES", "DENSE_TILES", "AFFINE_TILES",
           "gemm_tile", "popcount_i32", "PRODUCT_FNS", "chunked_bitwise_matmul",
           "scale_epilogue", "on_cuda", "gemm_dims", "row_stride",
           "check_f32_vec", "check_row_scale", "sm_count",
           "lowbit_matmul_call"]


@dataclasses.dataclass(frozen=True, order=True)
class TileConfig:
    """One blocking choice of the plain versions: ``word_chunk`` is the
    words per step (for the indexed backend, the segments per step) and
    ``seg_bits`` the indexed backend's segment width in bits (the
    reference reads it from ``block_kw``).  The CUDA kernels' tiles are
    not a choice of the caller: :func:`gemm_tile` derives the popcount
    GeMM's from the shape, and the others are compiled in."""
    word_chunk: int = 8
    seg_bits: int = 8


DEFAULT_TILES: Dict[str, TileConfig] = {
    "bnn": TileConfig(),
    "tnn": TileConfig(),
    "tbn": TileConfig(),
}


# Square CTA tiles compiled into the GeMM kernels, largest first: the
# popcount GeMM (csrc/lowbit_gemm.cu; 256 threads, 4x4, 2x2 or 1x1
# outputs each), the dense GeMM (csrc/dense_tc.cu) and the u8/u4 GeMM
# (csrc/affine_gemm.cu; both 4 warps of 2x2 or 1x1 wmma fragments).  The
# reference's 128x128x256-word tiles are VMEM choices and do not carry
# over.
GEMM_TILES = (64, 32, 16)
DENSE_TILES = (64, 32)
AFFINE_TILES = (64, 32)


def gemm_tile(m: int, n: int, sms: int, tiles=GEMM_TILES) -> int:
    """A GeMM kernel's CTA tile for an (m, n) output on a card of ``sms``
    SMs: the largest of ``tiles`` whose grid has a block for every SM, so
    a CTA's A rows are reused across as many columns as possible; the
    smallest when none has, so the work of a small product spreads over
    as many SMs as it can (at the paper's GEMM_GRID sizes a 64x64 tile
    gives 2-12 CTAs on 132 SMs)."""
    for t in tiles:
        if -(-m // t) * -(-n // t) >= sms:
            return t
    return tiles[-1]


# ---------------------------------------------------------------------------
# Plain popcount core
# ---------------------------------------------------------------------------

def popcount_i32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words holding uint32 bits (SWAR on
    int64, so no shift sign-extends)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def _bnn_product(a, b):
    return popcount_i32(a[0] ^ b[0])


def _tnn_product(a, b):
    ap, am = a
    bp, bm = b
    return popcount_i32((ap & bp) | (am & bm)) - popcount_i32((ap & bm) | (am & bp))


def _tbn_product(a, b):
    ap, am = a
    (bb,) = b
    nbb = ~bb
    return popcount_i32((ap | bb) & (am | nbb)) - popcount_i32((ap | nbb) & (am | bb))


# Per-word signed contribution of each mode: eq. (6)'s XOR popcount (the
# k - 2*sum finalization is applied by the caller), eq. (7), Table I.
PRODUCT_FNS: Dict[QuantMode, Callable] = {
    QuantMode.BNN: _bnn_product,
    QuantMode.TNN: _tnn_product,
    QuantMode.TBN: _tbn_product,
}


def chunked_bitwise_matmul(product_fn, a_ops: Sequence[torch.Tensor],
                           b_ops: Sequence[torch.Tensor], *,
                           word_chunk: int = 8,
                           epilogue: Optional[Callable] = None,
                           max_elems: int = 1 << 24) -> torch.Tensor:
    """acc[m, n] = sum over word chunks of product_fn(a_chunk, b_chunk).

    a_ops: (m, kw) int32 planes; b_ops: (n, kw) int32 planes.  Rows are
    chunked so the (rows, n, word_chunk) intermediate holds at most
    ``max_elems`` elements.  ``epilogue`` maps the int32 accumulator to
    the output.
    """
    m, kw = a_ops[0].shape
    n = b_ops[0].shape[0]
    wc = max(1, min(word_chunk, kw))
    rows = max(1, max_elems // max(1, n * wc))
    acc = torch.zeros((m, n), dtype=torch.int32, device=a_ops[0].device)
    for r0 in range(0, m, rows):
        r1 = min(m, r0 + rows)
        for k0 in range(0, kw, wc):
            k1 = min(kw, k0 + wc)
            a_ch = [a[r0:r1, None, k0:k1] for a in a_ops]
            b_ch = [b[None, :, k0:k1] for b in b_ops]
            acc[r0:r1] += product_fn(a_ch, b_ch).sum(dim=-1, dtype=torch.int32)
    return acc if epilogue is None else epilogue(acc)


def scale_epilogue(acc: torch.Tensor, row_scale: torch.Tensor,
                   col_scale: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """eq. (2): ``acc * row_scale * col_scale (+ bias)`` in float32, in
    this order (the reference's order; each step rounds on its own, as
    ``__fmul_rn``/``__fadd_rn`` do in the kernels)."""
    out = acc.to(torch.float32) * row_scale * col_scale
    if bias is not None:
        out = out + bias
    return out


# ---------------------------------------------------------------------------
# The Hopper GeMM kernel (csrc/lowbit_gemm.cu)
# ---------------------------------------------------------------------------

_MODE_ID = {QuantMode.BNN: 0, QuantMode.TNN: 1, QuantMode.TBN: 2}
_PLANES = {QuantMode.BNN: (1, 1), QuantMode.TNN: (2, 2), QuantMode.TBN: (2, 1)}


def on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    """Which version a kernel wrapper runs: True (the kernel) when every
    operand lies on a CUDA device, False (the plain version) when none
    does; a mix raises."""
    cuda = other = False
    for t in tensors:
        if t is not None:
            if t.is_cuda:
                cuda = True
            else:
                other = True
    if cuda and other:
        raise ValueError("kernel operands must all lie on CUDA or all on "
                         "the CPU, got a mix")
    return cuda


def _check_plane(name: str, p: torch.Tensor, rows: int, kw: int,
                 device: int) -> None:
    if p.dtype is not torch.int32:
        raise TypeError(f"{name}: planes must be torch.int32, got {p.dtype}")
    if p.shape != (rows, kw) or not p.is_contiguous():
        raise ValueError(f"{name}: expected contiguous ({rows}, {kw}) planes, "
                         f"got {tuple(p.shape)}")
    if p.get_device() != device:
        raise ValueError(f"{name}: planes on different devices")


def gemm_dims(mode: QuantMode, a_planes: Sequence[torch.Tensor],
              b_planes: Sequence[torch.Tensor]) -> Tuple[int, int, int, int]:
    """(m, n, kw, CUDA device index) of a GeMM kernel's bit planes, A
    (m, kw) and B^T (n, kw).  Raises on what a kernel would read wrongly:
    a wrong plane count, dtype, rank, shape or layout, planes on several
    devices or off the card, or indices past 32 bits."""
    na, nb = _PLANES[mode]
    if len(a_planes) != na or len(b_planes) != nb:
        raise ValueError(f"{mode.value} GeMM takes {na} + {nb} planes, got "
                         f"{len(a_planes)} + {len(b_planes)}")
    a0, b0 = a_planes[0], b_planes[0]
    if a0.ndim != 2 or b0.ndim != 2:
        raise ValueError(f"planes must be 2-D, got {tuple(a0.shape)} and "
                         f"{tuple(b0.shape)}")
    (m, kw), n = a0.shape, b0.shape[0]
    device = a0.get_device()
    for p in a_planes:
        _check_plane("a", p, m, kw, device)
    for p in b_planes:
        _check_plane("b", p, n, kw, device)
    if device < 0:
        raise ValueError(f"GeMM kernels need CUDA planes, got {a0.device}")
    if m * kw >= 2**31:
        raise ValueError("GeMM kernels index A words with 32-bit ints")
    return m, n, kw, device


def row_stride(row: torch.Tensor, m: int) -> int:
    """Stride of the per-row scale over the m output rows, as the kernels
    read it (``row[i * stride]``): 0 for one per-tensor value (one
    element, or (m, 1) expanded from it, as ``qmm`` never builds), 1 for
    (m, 1) values in a row."""
    if row.numel() == 1:
        return 0
    if row.shape == (m, 1) and row.stride(0) in (0, 1):
        return row.stride(0)
    raise ValueError(f"row_scale: expected one value or (m={m}, 1) with "
                     f"stride 0 or 1, got {tuple(row.shape)} strides "
                     f"{row.stride()}")


def check_f32_vec(name: str, v: Optional[torch.Tensor], n: int,
                  device: int) -> None:
    """A float32 vector of n contiguous values on CUDA device ``device``
    (or None)."""
    if v is None:
        return
    if v.dtype is not torch.float32 or v.get_device() != device:
        raise TypeError(f"{name}: expected float32 on cuda:{device}, got "
                        f"{v.dtype} on {v.device}")
    if v.numel() != n or not v.is_contiguous():
        raise ValueError(f"{name}: expected {n} contiguous values, got "
                         f"shape {tuple(v.shape)}")


def check_row_scale(row: torch.Tensor, m: int, device: int) -> int:
    """:func:`row_stride` of a float32 row scale on CUDA device
    ``device``."""
    if row.dtype is not torch.float32 or row.get_device() != device:
        raise TypeError(f"row_scale: expected float32 on cuda:{device}, got "
                        f"{row.dtype} on {row.device}")
    return row_stride(row, m)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


_GEMM_KEYS = {(mode, fused): f"lowbit_gemm_{mode.value}_{'fused' if fused else 'i32'}"
              for mode in _MODE_ID for fused in (False, True)}
_SMS: Dict[int, int] = {}


def sm_count(device: int) -> int:
    """SMs of CUDA device ``device``, read once."""
    sms = _SMS.get(device)
    if sms is None:
        sms = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sms


def lowbit_matmul_call(mode: QuantMode, a_planes: Sequence[torch.Tensor],
                       b_planes: Sequence[torch.Tensor], k_valid: int, *,
                       row_scale: Optional[torch.Tensor] = None,
                       col_scale: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/lowbit_gemm.cu`` on CUDA planes.

    Without ``row_scale``/``col_scale`` the int32 core runs (BNN already
    finalized to ``k_valid - 2*popcount``); with them, the fused kernel
    applies eq. (2) in-kernel and writes float32: ``row_scale`` one
    per-tensor value or (m, 1) (:func:`row_stride`; never copied),
    ``col_scale`` and ``bias`` n contiguous values.  Raises on anything
    the kernel does not take; never falls back.
    """
    m, n, kw, device = gemm_dims(mode, a_planes, b_planes)
    fused = row_scale is not None or col_scale is not None
    stride = 0
    if fused:
        if row_scale is None or col_scale is None:
            raise ValueError("the fused GeMM needs both row_scale and col_scale")
        stride = check_row_scale(row_scale, m, device)
        check_f32_vec("col_scale", col_scale, n, device)
        check_f32_vec("bias", bias, n, device)
    elif bias is not None:
        raise ValueError("bias needs the fused GeMM (pass the scales)")
    out = a_planes[0].new_empty((m, n), dtype=torch.float32 if fused
                                else torch.int32)
    if m == 0 or n == 0:
        return out
    _build.launch(
        "lowbit_gemm_launch", _GEMM_KEYS[(mode, fused)], device, _MODE_ID[mode],
        int(fused), a_planes[0].data_ptr(), a_planes[-1].data_ptr(),
        b_planes[0].data_ptr(), b_planes[-1].data_ptr(), m, n, kw, int(k_valid),
        gemm_tile(m, n, sm_count(device)), _ptr(row_scale), stride,
        _ptr(col_scale), _ptr(bias), out.data_ptr())
    return out
