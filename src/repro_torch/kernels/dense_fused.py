"""Dense backend: the bit planes decoded to +-1/0 values and multiplied on
the tensor cores, for both registry layouts.

Counterpart of ``repro/kernels/dense_fused.py``.  The packed bit-plane
words are what travels from device memory; the decode to +-1/0 happens
on chip, ahead of the product, and the eq. (2) epilogue runs in-kernel:

* gemm (``dense_matmul_fused_cuda``, replaces
  ``dense_matmul_fused_pallas``): ``csrc/dense_tc.cu`` decodes a tile of
  each operand's planes to int8 in shared memory and runs wmma with int32
  accumulators;
* im2col_fused (``dense_conv_fused_cuda``, replaces
  ``dense_conv_fused_pallas``): the popcount conv's packing pass
  quantizes each padded input pixel once; the same kernel file's conv
  kernel gathers the packed words per CTA, decodes them and the
  positional weight words to +-1/0 int8 in shared memory, and
  multiplies; the im2col matrix never exists.

Both register under ``(mode, "dense", fused=True)`` for their layout; on
CPU tensors they run their plain versions.  The plain versions
(``dense_matmul_fused_torch``, ``dense_conv_fused_torch``) unpack with
``encoding.unpack_*`` and ``conv_fused.gather_patch_tile`` /
``quantize_patch_values`` and take float32 products in row chunks with
TF32 off.  Every count is exact — the products are +-1/0 and every
partial sum an integer below 2**24 — so all three (kernel, plain,
popcount backends) give the same integers, and with the shared epilogue
order the same floats.  The materializing unfused oracle
``(mode, "dense", fused=False)`` is :func:`dense_matmul_torch` (registered
in ``ops``).

Binary padding: zero pad bits decode to +1 on both operands, so the BNN
gemm zeroes A past ``k_valid`` (the plain version slices to ``k_valid``);
the conv uses only the first Cin bits of each patch position's words.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.core import encoding
from repro_torch.kernels import _build, registry
from repro_torch.kernels._matmul_common import (
    _MODE_ID, _PLANES, DENSE_TILES, _ptr, check_f32_vec, check_row_scale, cta_tile,
    gemm_dims, runs_kernel, scale_epilogue)
from repro_torch.kernels.conv_fused import (
    _conv_problem, conv_pack_cuda, conv_spatial_pad, gather_patch_tile, packed_conv_args,
    quantize_patch_values)
from repro_torch.kernels.modes import QuantMode
from repro_torch.tune.space import DENSE_SPACE

__all__ = ["unpack_values", "dense_matmul_torch", "dense_matmul_fused_torch",
           "dense_matmul_fused_cuda", "dense_conv_fused_torch",
           "dense_conv_fused_cuda"]

# Which side carries two (plus, minus) planes vs one sign plane.
_TERNARY_A = {mode: planes[0] == 2 for mode, planes in _PLANES.items()}
_TERNARY_B = {mode: planes[1] == 2 for mode, planes in _PLANES.items()}

# Elements of a float32 operand chunk the plain versions unpack at once.
_CHUNK_ELEMS = 1 << 24


def unpack_values(planes: Sequence[torch.Tensor], k: int, ternary: bool,
                  dtype=torch.float32) -> torch.Tensor:
    """Bit-plane words (rows, kw) -> +-1/0 values (rows, k)."""
    if ternary:
        return encoding.unpack_ternary(planes[0], planes[1], k, dtype)
    return encoding.unpack_binary(planes[0], k, dtype)


def _exact_f32_product(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a (m, k) @ b_t.T (k, n) for +-1/0 float32 values -> int32, in row
    chunks; exact with TF32 off, since |partial sums| <= k < 2**24."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = max(1, _CHUNK_ELEMS // max(1, a.shape[1]))
    out = torch.empty((a.shape[0], b_t.shape[0]), dtype=torch.int32,
                      device=a.device)
    for r0 in range(0, a.shape[0], rows):
        out[r0:r0 + rows] = torch.matmul(a[r0:r0 + rows], b_t.t()).to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# gemm layout
# ---------------------------------------------------------------------------

def dense_matmul_torch(mode: QuantMode, a_planes, b_planes,
                       k_valid: int) -> torch.Tensor:
    """Materializing dense core: unpack both operands to +-1/0 (sliced to
    ``k_valid``), one exact product -> int32 (m, n).  The unfused
    ``(mode, "dense")`` cell and the oracle of the dense kernels."""
    av = unpack_values(a_planes, k_valid, _TERNARY_A[mode])
    bv = unpack_values(b_planes, k_valid, _TERNARY_B[mode])
    return _exact_f32_product(av, bv)


def dense_matmul_fused_torch(mode: QuantMode, a_planes, b_planes,
                             k_valid: int, row_scale: torch.Tensor,
                             col_scale: torch.Tensor,
                             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain fused dense GeMM: float32 (m, n); row_scale (m, 1) or one
    value, col_scale and bias (1, n)."""
    acc = dense_matmul_torch(mode, a_planes, b_planes, k_valid)
    return scale_epilogue(acc, row_scale, col_scale, bias)


_GEMM_KEYS = {mode: f"dense_gemm_{mode.value}" for mode in _MODE_ID}
_CONV_KEYS = {mode: f"dense_conv_{mode.value}" for mode in _MODE_ID}


def dense_matmul_fused_cuda(mode: QuantMode, a_planes, b_planes,
                            k_valid: int, row_scale: torch.Tensor,
                            col_scale: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            tile: Optional[int] = None) -> torch.Tensor:
    """Fused dense GeMM, float32 (m, n): ``csrc/dense_tc.cu`` on CUDA
    operands (raises on anything it does not take), the plain version on
    CPU operands.  ``row_scale`` one per-tensor value or (m, 1) (never
    copied), ``col_scale`` and ``bias`` n contiguous values; ``tile`` the
    CTA tile (``_matmul_common.cta_tile`` over ``DENSE_TILES``)."""
    if not runs_kernel(*a_planes, *b_planes, row_scale, col_scale, bias):
        return dense_matmul_fused_torch(mode, a_planes, b_planes, k_valid,
                                        row_scale, col_scale, bias)
    m, n, kw, device = gemm_dims(mode, a_planes, b_planes)
    stride = check_row_scale(row_scale, m, device)
    check_f32_vec("col_scale", col_scale, n, device)
    check_f32_vec("bias", bias, n, device)
    out = a_planes[0].new_empty((m, n), dtype=torch.float32)
    if m == 0 or n == 0:
        return out
    if out.is_meta:
        _build.record(_GEMM_KEYS[mode], m=m, n=n, kw=kw, k=k_valid)
        return out
    _build.launch(
        "dense_gemm_launch", _GEMM_KEYS[mode], device, _MODE_ID[mode],
        a_planes[0].data_ptr(), a_planes[-1].data_ptr(), b_planes[0].data_ptr(),
        b_planes[-1].data_ptr(), m, n, kw, int(k_valid),
        cta_tile(tile, m, n, device, DENSE_TILES), row_scale.data_ptr(),
        stride, col_scale.data_ptr(), _ptr(bias), out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# im2col_fused layout
# ---------------------------------------------------------------------------

def _weight_values(mode: QuantMode, b_planes, geometry) -> torch.Tensor:
    """Positional weight words (cout, kh*kw*cw) -> +-1/0 (cout, kh*kw*cin):
    each position's first Cin bits, its in-word pads dropped."""
    kh, kw, cin, cout = geometry
    cw = -(-cin // 32)

    def bits(p):
        return encoding.unpack_bits(p.reshape(cout, kh * kw, cw), cw * 32)[..., :cin]

    if _TERNARY_B[mode]:
        vals = bits(b_planes[0]) - bits(b_planes[1])
    else:
        vals = 1 - 2 * bits(b_planes[0])
    return vals.reshape(cout, kh * kw * cin).to(torch.float32)


def dense_conv_fused_torch(mode: QuantMode, x: torch.Tensor, b_planes,
                           geometry, stride: int, padding: str,
                           stats: Dict[str, torch.Tensor],
                           col_scale: torch.Tensor,
                           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain fused dense conv -> float32 (B, OH, OW, Cout): patch tiles
    gathered from the padded input and quantized to +-1/0, times the
    unpacked positional weights, then eq. (2) with the scalar act scale;
    col_scale and bias (1, Cout)."""
    kh, kw, cin, cout = geometry
    xp, (oh, ow) = conv_spatial_pad(x.to(torch.float32), kh, kw, stride,
                                    padding)
    bsz = xp.shape[0]
    m = bsz * oh * ow
    wv = _weight_values(mode, b_planes, geometry)
    thr = None if mode == QuantMode.BNN else stats["thr"]
    rows = max(1, min(m, _CHUNK_ELEMS // (kh * kw * cin)))
    acc = torch.empty((m, cout), dtype=torch.int32, device=xp.device)
    for pid in range(-(-m // rows)):
        patch = gather_patch_tile(xp, pid, block_m=rows, m=m, oh=oh, ow=ow,
                                  stride=stride, kh=kh, kw=kw)
        av = quantize_patch_values(patch, mode, thr).reshape(rows, -1)
        r0 = pid * rows
        acc[r0:r0 + rows] = _exact_f32_product(av, wv)[:m - r0]
    y = scale_epilogue(acc, stats["scale"].reshape(1, 1), col_scale, bias)
    return y.reshape(bsz, oh, ow, cout)


def dense_conv_fused_cuda(mode: QuantMode, x: torch.Tensor, b_planes,
                          geometry, stride: int, padding: str,
                          stats: Dict[str, torch.Tensor],
                          col_scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused dense conv -> float32 (B, OH, OW, Cout): on CUDA operands the
    pack kernel (``conv_fused.conv_pack_cuda``) then ``csrc/dense_tc.cu``'s
    conv kernel, on the current stream with no host sync (raises on
    anything they do not take); the plain version on CPU operands."""
    if not runs_kernel(x, *b_planes, *stats.values(), col_scale, bias):
        return dense_conv_fused_torch(mode, x, b_planes, geometry, stride,
                                      padding, stats, col_scale, bias)
    kh, kw, cin, cout = geometry
    out, dims, words, scale, col, bias = packed_conv_args(
        mode, x, b_planes, geometry, stride, padding, stats, col_scale, bias)
    bsz, _, _, _, _, _, _, oh, ow = dims
    if out.numel() == 0:
        return out.reshape(bsz, oh, ow, cout)
    a = conv_pack_cuda(mode, x, kh, kw, stride, padding, stats)
    if out.is_meta:
        _build.record(_CONV_KEYS[mode], **_conv_problem(dims, cout, words))
        return out.reshape(bsz, oh, ow, cout)
    _build.launch(
        "dense_conv_launch", _CONV_KEYS[mode], x.get_device(), _MODE_ID[mode],
        a[0].data_ptr(), a[-1].data_ptr(), *dims, b_planes[0].data_ptr(),
        b_planes[-1].data_ptr(), cout, words, scale.data_ptr(), col.data_ptr(),
        _ptr(bias), out.data_ptr())
    return out.reshape(bsz, oh, ow, cout)


# ---------------------------------------------------------------------------
# Registration — (mode, "dense", fused=True) for gemm AND im2col_fused
# ---------------------------------------------------------------------------

def _register_dense_kernels():
    def make_gemm(mode):
        def fn(a, b, k, r, c, bias, *, tiles=None):
            return dense_matmul_fused_cuda(mode, a, b, k, r, c, bias,
                                           tile=tiles and tiles.cta_tile)
        return fn

    def make_conv(mode):
        def fn(x, b_planes, geometry, stride, padding, stats, col_scale,
               bias, *, tiles=None):
            return dense_conv_fused_cuda(mode, x, b_planes, geometry, stride,
                                         padding, stats, col_scale, bias)
        return fn

    for mode in (QuantMode.BNN, QuantMode.TNN, QuantMode.TBN):
        registry.register(
            mode, "dense", fused=True, epilogue="in-kernel",
            compute="cuda-imma", tunable=DENSE_SPACE,
            description="csrc/dense_tc.cu: planes decoded to +-1/0 int8 in "
                        "shared memory, wmma s8 -> s32, eq. (2) in-kernel",
        )(make_gemm(mode))
        registry.register(
            mode, "dense", fused=True, layout=registry.LAYOUT_IM2COL,
            epilogue="in-kernel", compute="cuda-imma",
            description="pack once (csrc/lowbit_conv.cu), then "
                        "csrc/dense_tc.cu: packed-word gather per CTA, "
                        "decode to int8, wmma, epilogue in-kernel",
        )(make_conv(mode))


_register_dense_kernels()
