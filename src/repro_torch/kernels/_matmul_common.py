"""Shared plumbing of the low-bit GeMM: tiles, the popcount core's plain
PyTorch version, the eq. (2) epilogue, and the launcher of the Hopper
kernel ``csrc/lowbit_gemm.cu``.

Counterpart of ``repro/kernels/_matmul_common.py``.  The reference runs
a sequential ``(m/bm, n/bn, kw/bkw)`` Pallas grid whose output tile stays
resident in VMEM across the k axis.  On Hopper the blocks run in
parallel and in no order, so each CTA owns one output tile and loops
over the k words itself (``lowbit_matmul_call`` below launches it).

The plain version (:func:`chunked_bitwise_matmul`) is the counterpart of
the reference's k-chunked ``lax.scan`` (``ops._chunked_bitwise_matmul``):
rows and words are chunked so the ``(rows, n, word_chunk)`` intermediate
stays bounded, and torch has no popcount, so :func:`popcount_i32` is the
SWAR bit count on int64.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.modes import QuantMode

__all__ = ["TileConfig", "DEFAULT_TILES", "popcount_i32", "PRODUCT_FNS",
           "chunked_bitwise_matmul", "scale_epilogue", "on_cuda",
           "lowbit_matmul_call"]


@dataclasses.dataclass(frozen=True, order=True)
class TileConfig:
    """One blocking choice for a low-bit GeMM.

    ``block_m/block_n/block_kw`` are the CUDA kernels' CTA tile (output
    rows x output columns x 32-bit words staged in shared memory per
    step); ``word_chunk`` is the words per step of the plain version.
    """
    block_m: int = 64
    block_n: int = 64
    block_kw: int = 32
    word_chunk: int = 8


# Re-derived for Hopper (the reference's 128x128x256-word tiles are VMEM
# choices).  A CTA of 256 threads computes a 64x64 tile, 4x4 outputs per
# thread in int32 registers; 32 words of each plane are staged in shared
# memory per step: (64+64) x 32 x 4 B = 16 KiB per plane pair, 32 KiB for
# the two-plane modes — under the 48 KiB static limit, so no
# cudaFuncSetAttribute.  These values are compiled into csrc/*.cu
# (lowbit::BM/BN/BK in lowbit_core.cuh).
DEFAULT_TILES: Dict[str, TileConfig] = {
    "bnn": TileConfig(),
    "tnn": TileConfig(),
    "tbn": TileConfig(),
}


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
    operand lies on a CUDA device, False (the plain version) when every
    one lies on the CPU; anything else raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel operands must all lie on CUDA or all on the "
                     f"CPU, got {sorted(kinds)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check_planes(name: str, planes, count: int, rows_kw=None):
    if len(planes) != count:
        raise ValueError(f"{name}: expected {count} plane(s), got {len(planes)}")
    first = planes[0]
    for p in planes:
        if p.dtype != torch.int32:
            raise TypeError(f"{name}: planes must be torch.int32, got {p.dtype}")
        if p.ndim != 2 or not p.is_contiguous():
            raise ValueError(f"{name}: planes must be contiguous 2-D, got "
                             f"shape {tuple(p.shape)}")
        if p.shape != first.shape or p.device != first.device:
            raise ValueError(f"{name}: planes differ in shape or device")
    if rows_kw is not None and first.shape[1] != rows_kw:
        raise ValueError(f"{name}: {first.shape[1]} words, expected {rows_kw}")


def check_f32_vec(name: str, v: Optional[torch.Tensor], n: int,
                  device: torch.device) -> None:
    if v is None:
        return
    if v.dtype != torch.float32 or v.device != device:
        raise TypeError(f"{name}: expected float32 on {device}, got "
                        f"{v.dtype} on {v.device}")
    if v.numel() != n or not v.is_contiguous():
        raise ValueError(f"{name}: expected {n} contiguous values, got "
                         f"shape {tuple(v.shape)}")


def lowbit_matmul_call(mode: QuantMode, a_planes: Sequence[torch.Tensor],
                       b_planes: Sequence[torch.Tensor], k_valid: int, *,
                       row_scale: Optional[torch.Tensor] = None,
                       col_scale: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/lowbit_gemm.cu`` on CUDA planes.

    Without ``row_scale``/``col_scale`` the int32 core runs (BNN already
    finalized to ``k_valid - 2*popcount``); with them, the fused kernel
    applies eq. (2) in-kernel and writes float32.  Raises on anything the
    kernel does not take; never falls back.
    """
    na, nb = _PLANES[mode]
    _check_planes("a", a_planes, na)
    m, kw = a_planes[0].shape
    _check_planes("b", b_planes, nb, rows_kw=kw)
    n = b_planes[0].shape[0]
    dev = a_planes[0].device
    if dev.type != "cuda" or b_planes[0].device != dev:
        raise ValueError(f"lowbit GeMM kernel needs CUDA planes on one "
                         f"device, got {dev} and {b_planes[0].device}")
    fused = row_scale is not None or col_scale is not None
    if fused:
        if row_scale is None or col_scale is None:
            raise ValueError("the fused GeMM needs both row_scale and col_scale")
        check_f32_vec("row_scale", row_scale, m, dev)
        check_f32_vec("col_scale", col_scale, n, dev)
        check_f32_vec("bias", bias, n, dev)
    elif bias is not None:
        raise ValueError("bias needs the fused GeMM (pass the scales)")
    out = torch.empty((m, n), device=dev,
                      dtype=torch.float32 if fused else torch.int32)
    if m == 0 or n == 0:
        return out
    a0, a1 = a_planes[0], a_planes[-1]
    b0, b1 = b_planes[0], b_planes[-1]
    lib = _build.load("lowbit_gemm")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lowbit_gemm_launch(
            _MODE_ID[mode], int(fused), _ptr(a0), _ptr(a1), _ptr(b0),
            _ptr(b1), m, n, kw, int(k_valid), _ptr(row_scale),
            _ptr(col_scale), _ptr(bias), _ptr(out), ctypes.c_void_p(stream))
    _build.check_launch(lib, rc, f"lowbit_gemm[{mode.value}]")
    _build.count_launch(f"lowbit_gemm_{mode.value}_{'fused' if fused else 'i32'}")
    return out
