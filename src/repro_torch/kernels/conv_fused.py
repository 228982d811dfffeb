"""Implicit-im2col low-bit convolution (registry layout ``im2col_fused``).

Counterpart of ``repro/kernels/conv_fused.py``.  The conv reads the raw
(B, H, W, Cin) activations, quantizes and packs them along the channel
axis and gathers *packed* patch words, so the float patch matrix never
exists.  This is exact against the materializing oracle (im2col +
``ops.qmm(act_stats=...)``) because the activation quantizers are
per-tensor: :func:`conv_act_stats` computes the scalars once from the
padded input, each element weighted by the number of patches holding
it, and every path quantizes with those same scalars.

Weights arrive in the per-patch-position layout (:func:`conv_weight_planes`:
the contiguous payload when ``Cin % 32 == 0``, the pack-time positional
planes otherwise, an exact repack for legacy containers).

Two backends:

* ``"cuda"`` — ``csrc/lowbit_conv.cu`` (replaces the reference's
  ``_conv_pallas_fused``): each CTA derives its output pixels from
  ``blockIdx``, gathers the patch values from global memory, quantizes
  them with the device scalars ``thr``/``scale`` and packs them with
  ``__ballot_sync``, then runs the popcount core and the eq. (6) / eq. (2)
  epilogue in-kernel.  On CPU tensors the entry runs the plain version.
* ``"torch"`` — the plain version (counterpart of ``_conv_xla_fused``):
  quantize and pack the padded input once, gather packed words with one
  strided slice per patch position, then the chunked popcount with the
  epilogue.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.quantize import f32_scalar
from repro_torch.kernels import _build, registry
from repro_torch.kernels._matmul_common import (
    DEFAULT_TILES, PRODUCT_FNS, _MODE_ID, check_f32_vec, chunked_bitwise_matmul,
    on_cuda, scale_epilogue)
from repro_torch.kernels.modes import QuantMode

__all__ = ["conv_out_hw", "conv_spatial_pad", "conv_act_stats",
           "conv_problem_dims", "geom_tag", "im2col_hbm_bytes",
           "conv_weight_planes", "gather_patch_tile",
           "quantize_patch_values", "conv_fused_cuda", "conv_fused_torch"]


# ---------------------------------------------------------------------------
# Geometry helpers (core.conv.im2col delegates here, so the oracle and the
# kernels agree on the patch grid)
# ---------------------------------------------------------------------------

def conv_out_hw(h: int, w: int, kh: int, kw: int, stride: int,
                padding: str) -> Tuple[int, int, int, int]:
    """(OH, OW, pad_h_total, pad_w_total) for one conv geometry."""
    if padding == "SAME":
        oh, ow = -(-h // stride), -(-w // stride)
        ph = max((oh - 1) * stride + kh - h, 0)
        pw = max((ow - 1) * stride + kw - w, 0)
    elif padding == "VALID":
        oh = (h - kh) // stride + 1
        ow = (w - kw) // stride + 1
        ph = pw = 0
    else:
        raise ValueError(padding)
    return oh, ow, ph, pw


def conv_spatial_pad(x: torch.Tensor, kh: int, kw: int, stride: int,
                     padding: str):
    """Apply the conv's spatial zero padding: (B, H, W, C) ->
    ((B, Hp, Wp, C), (OH, OW)); the extra row/column of an odd total goes
    to the bottom/right."""
    _, h, w, _ = x.shape
    oh, ow, ph, pw = conv_out_hw(h, w, kh, kw, stride, padding)
    if ph or pw:
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    return x, (oh, ow)


def geom_tag(kh: int, kw: int, stride: int, padding: str) -> str:
    """Compact conv-geometry tag."""
    return f"{kh}x{kw}s{stride}{padding.lower()}"


def conv_problem_dims(x_shape, geometry, stride: int, padding: str):
    """(m, n, k, geom_tag) of the implicit im2col GeMM for one call."""
    b, h, w, _ = x_shape
    kh, kw, cin, cout = geometry
    oh, ow, _, _ = conv_out_hw(h, w, kh, kw, stride, padding)
    return b * oh * ow, cout, kh * kw * cin, geom_tag(kh, kw, stride, padding)


def im2col_hbm_bytes(x_shape, geometry, stride: int, padding: str,
                     mode: QuantMode = QuantMode.TNN) -> Dict[str, int]:
    """Bytes of the im2col A operand, materializing vs fused: the float32
    patch matrix the oracle writes, vs the packed activation planes the
    plain fused version stages (the CUDA kernel stages none)."""
    b, h, w, _ = x_shape
    kh, kw, cin, _ = geometry
    oh, ow, ph, pw = conv_out_hw(h, w, kh, kw, stride, padding)
    m, k = b * oh * ow, kh * kw * cin
    planes = 1 if mode == QuantMode.BNN else 2
    cw = -(-cin // 32)
    return {"materialized": m * k * 4,
            "fused": b * (h + ph) * (w + pw) * cw * 4 * planes}


@functools.lru_cache(maxsize=64)
def _patch_multiplicity(hp: int, wp: int, kh: int, kw: int, stride: int,
                        oh: int, ow: int, device: torch.device) -> torch.Tensor:
    """How many patches contain each padded-input pixel, as a (hp, wp)
    float32 tensor on ``device`` — built and copied once per geometry (a
    host-to-device copy of pageable memory syncs the stream)."""
    mult = np.zeros((hp, wp), np.float32)
    for dy in range(kh):
        for dx in range(kw):
            mult[dy:dy + (oh - 1) * stride + 1:stride,
                 dx:dx + (ow - 1) * stride + 1:stride] += 1
    return torch.from_numpy(mult).to(device)


# ---------------------------------------------------------------------------
# Shared activation-quantization statistics
# ---------------------------------------------------------------------------

def conv_act_stats(x: torch.Tensor, mode: QuantMode, kh: int, kw: int,
                   stride: int = 1, padding: str = "SAME"
                   ) -> Dict[str, torch.Tensor]:
    """Scalar quantization statistics of the *implicit* im2col matrix:
    mean |A| (BNN ``{"scale"}``), and for the ternary modes the TWN
    threshold and the masked mean (``{"thr", "scale"}``), in one O(|x|)
    pass with each padded-input element weighted by its multiplicity in
    the im2col matrix.  Float32 device scalars; nothing here syncs the
    stream once a geometry has been seen.
    """
    xp, (oh, ow) = conv_spatial_pad(x.to(torch.float32), kh, kw, stride,
                                    padding)
    b, hp, wp, c = xp.shape
    mult = _patch_multiplicity(hp, wp, kh, kw, stride, oh, ow, xp.device)
    w4 = mult[None, :, :, None]
    absx = xp.abs()
    count = f32_scalar(b * oh * ow * kh * kw * c, xp)
    mean_abs = (absx * w4).sum() / count
    if mode == QuantMode.BNN:
        return {"scale": mean_abs}
    thr = 0.7 * mean_abs
    mask = (absx > thr).to(torch.float32)
    nnz = (mask * w4).sum()
    alpha = (absx * mask * w4).sum() / nnz.clamp(min=1.0)
    return {"thr": thr, "scale": alpha}


# ---------------------------------------------------------------------------
# Operand packing in the per-patch-position layout
# ---------------------------------------------------------------------------

def _pack_activation_planes(xp: torch.Tensor, mode: QuantMode,
                            stats: Dict[str, torch.Tensor]):
    """Quantize the padded input elementwise and pack bit planes along the
    channel axis: each pixel becomes ceil(C/32) words per plane."""
    from repro_torch.core import encoding

    if mode == QuantMode.BNN:
        return (encoding.pack_bits(xp < 0),)           # +1 -> 0, -1 -> 1
    t = quantize_patch_values(xp, mode, stats["thr"])
    return (encoding.pack_bits(t > 0), encoding.pack_bits(t < 0))


def _conv_weight_planes(b_planes, mode: QuantMode, geometry):
    """Legacy repack: derive the per-patch-position planes from the
    contiguous-k payload (exact; containers packed by ``from_dense`` store
    them already)."""
    from repro_torch.core import encoding

    kh, kw, cin, cout = geometry
    if cin % 32 == 0:
        return tuple(b_planes)
    k = kh * kw * cin
    if mode == QuantMode.TNN:
        vals = encoding.unpack_ternary(b_planes[0], b_planes[1], k)
    else:
        vals = encoding.unpack_binary(b_planes[0], k)
    v3 = vals.reshape(cout, kh * kw, cin)
    if mode == QuantMode.TNN:
        return (encoding.pack_bits(v3 > 0).reshape(cout, -1),
                encoding.pack_bits(v3 < 0).reshape(cout, -1))
    return (encoding.pack_bits(v3 < 0).reshape(cout, -1),)


def conv_weight_planes(qt) -> Tuple[torch.Tensor, ...]:
    """Weight planes of a conv-packed QTensor in the per-patch-position
    layout: the payload itself when ``Cin % 32 == 0``, the stored
    positional planes otherwise, an exact repack for legacy containers."""
    from repro_torch.kernels.qtensor import PAYLOAD_KEYS, POS_PAYLOAD_KEYS

    cin = qt.geometry[2]
    planes = tuple(qt.payload[k] for k in PAYLOAD_KEYS[qt.mode])
    if cin % 32 == 0:
        return planes
    pos_keys = POS_PAYLOAD_KEYS[qt.mode]
    if all(k in qt.payload for k in pos_keys):
        return tuple(qt.payload[k] for k in pos_keys)
    return _conv_weight_planes(planes, qt.mode, qt.geometry)


def gather_patch_tile(xv: torch.Tensor, pid_m: int, *, block_m: int, m: int,
                      oh: int, ow: int, stride: int, kh: int,
                      kw: int) -> torch.Tensor:
    """Raw (block_m, kh*kw, Cin) float patch tile of m block ``pid_m`` from
    the padded input — the A-operand addressing the conv kernel does per
    CTA.  Rows past ``m`` re-gather row m-1."""
    mi = pid_m * block_m + torch.arange(block_m, device=xv.device)
    mi = mi.clamp(max=m - 1)
    bi = mi // (oh * ow)
    rem = mi % (oh * ow)
    hi = (rem // ow) * stride
    wi = (rem % ow) * stride
    dy = torch.arange(kh, device=xv.device)[:, None].expand(kh, kw)
    dx = torch.arange(kw, device=xv.device)[None, :].expand(kh, kw)
    patch = xv[bi[:, None, None], hi[:, None, None] + dy[None],
               wi[:, None, None] + dx[None]]           # (bm, kh, kw, C)
    return patch.reshape(block_m, kh * kw, xv.shape[-1])


def quantize_patch_values(patch: torch.Tensor, mode: QuantMode,
                          thr) -> torch.Tensor:
    """Elementwise per-tensor quantization to ±1/0 values; ``thr`` is
    ignored for BNN."""
    if mode == QuantMode.BNN:
        return torch.where(patch < 0, -1.0, 1.0)
    return torch.sign(patch) * (patch.abs() > thr)


# ---------------------------------------------------------------------------
# Plain version: pack once, gather packed words, chunked popcount
# ---------------------------------------------------------------------------

def conv_fused_torch(mode: QuantMode, x: torch.Tensor, b_planes, geometry,
                     stride: int, padding: str, stats: Dict[str, torch.Tensor],
                     col_scale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *,
                     word_chunk: int = DEFAULT_TILES["tnn"].word_chunk
                     ) -> torch.Tensor:
    """Plain fused conv -> float32 (B, OH, OW, Cout); col_scale and bias
    (1, Cout)."""
    kh, kw, _, cout = geometry
    k_valid = kh * kw * geometry[2]
    xp, (oh, ow) = conv_spatial_pad(x.to(torch.float32), kh, kw, stride,
                                    padding)
    bsz = xp.shape[0]
    a_full = _pack_activation_planes(xp, mode, stats)  # (B, Hp, Wp, cw) each
    cw = a_full[0].shape[-1]
    alpha = stats["scale"].reshape(1, 1)

    def gather(plane):
        # One strided slice per patch position, in the (dy, dx) order of
        # the im2col columns: im2col on packed words.
        slabs = [plane[:, dy:dy + (oh - 1) * stride + 1:stride,
                       dx:dx + (ow - 1) * stride + 1:stride, :]
                 for dy in range(kh) for dx in range(kw)]
        return torch.cat(slabs, dim=-1).reshape(bsz * oh * ow, kh * kw * cw)

    def epi(acc):
        val = k_valid - 2 * acc if mode == QuantMode.BNN else acc
        return scale_epilogue(val, alpha, col_scale, bias)

    y = chunked_bitwise_matmul(PRODUCT_FNS[mode], [gather(p) for p in a_full],
                               list(b_planes), word_chunk=word_chunk,
                               epilogue=epi)
    return y.reshape(bsz, oh, ow, cout)


# ---------------------------------------------------------------------------
# The Hopper kernel (csrc/lowbit_conv.cu)
# ---------------------------------------------------------------------------

def _launch_conv(mode: QuantMode, x: torch.Tensor, b_planes, geometry,
                 stride: int, padding: str, stats: Dict[str, torch.Tensor],
                 col_scale: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> torch.Tensor:
    kh, kw, cin, cout = geometry
    if x.dtype != torch.float32 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"conv kernel needs contiguous float32 (B, H, W, "
                         f"Cin), got {x.dtype} {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    if c != cin:
        raise ValueError(f"channel mismatch: x has {c}, geometry {geometry}")
    dev = x.device
    words = kh * kw * (-(-cin // 32))
    nplanes = 2 if mode == QuantMode.TNN else 1
    if len(b_planes) != nplanes:
        raise ValueError(f"{mode.value} conv takes {nplanes} weight plane(s)")
    for p in b_planes:
        if (p.dtype != torch.int32 or p.device != dev
                or tuple(p.shape) != (cout, words) or not p.is_contiguous()):
            raise ValueError(f"weight planes must be contiguous int32 "
                             f"({cout}, {words}) on {dev}, got {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")
    scale = stats["scale"]
    thr = stats.get("thr") if mode != QuantMode.BNN else None
    check_f32_vec("scale", scale, 1, dev)
    if mode != QuantMode.BNN:
        check_f32_vec("thr", thr, 1, dev)
    check_f32_vec("col_scale", col_scale, cout, dev)
    check_f32_vec("bias", bias, cout, dev)
    oh, ow, ph, pw = conv_out_hw(h, w, kh, kw, stride, padding)
    m = bsz * oh * ow
    if m >= 2**31 or x.numel() >= 2**31:
        raise ValueError("conv kernel indexes pixels with 32-bit ints")
    out = torch.empty((m, cout), dtype=torch.float32, device=dev)
    if m == 0:
        return out.reshape(bsz, oh, ow, cout)

    def ptr(t):
        return None if t is None else ctypes.c_void_p(t.data_ptr())

    lib = _build.load("lowbit_conv")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lowbit_conv_launch(
            _MODE_ID[mode], ptr(x), bsz, h, w, c, kh, kw, stride, ph // 2,
            pw // 2, oh, ow, ptr(b_planes[0]), ptr(b_planes[-1]), cout,
            words, kh * kw * cin, ptr(thr), ptr(scale), ptr(col_scale),
            ptr(bias), ptr(out), ctypes.c_void_p(stream))
    _build.check_launch(lib, rc, f"lowbit_conv[{mode.value}]")
    _build.count_launch(f"lowbit_conv_{mode.value}")
    return out.reshape(bsz, oh, ow, cout)


def conv_fused_cuda(mode: QuantMode, x: torch.Tensor, b_planes, geometry,
                    stride: int, padding: str,
                    stats: Dict[str, torch.Tensor], col_scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused conv -> float32 (B, OH, OW, Cout): the kernel on CUDA
    operands (raises on anything it does not take), the plain version on
    CPU operands."""
    if not on_cuda(x, *b_planes, *stats.values(), col_scale, bias):
        return conv_fused_torch(mode, x, b_planes, geometry, stride,
                                padding, stats, col_scale, bias)
    return _launch_conv(mode, x, b_planes, geometry, stride, padding, stats,
                        col_scale.reshape(-1).contiguous(),
                        None if bias is None else bias.reshape(-1).contiguous())


# ---------------------------------------------------------------------------
# Registration — (mode, backend, fused=True, layout="im2col_fused")
# ---------------------------------------------------------------------------

def _register_conv_kernels():
    def make(mode, plain):
        def fn(x, b_planes, geometry, stride, padding, stats, col_scale,
               bias, *, tiles=None):
            if plain:
                wc = (tiles or DEFAULT_TILES[mode.value]).word_chunk
                return conv_fused_torch(mode, x, b_planes, geometry, stride,
                                        padding, stats, col_scale, bias,
                                        word_chunk=wc)
            return conv_fused_cuda(mode, x, b_planes, geometry, stride,
                                   padding, stats, col_scale, bias)
        return fn

    for mode in (QuantMode.BNN, QuantMode.TNN, QuantMode.TBN):
        registry.register(
            mode, "cuda", fused=True, layout=registry.LAYOUT_IM2COL,
            epilogue="in-kernel", compute="cuda-popcount",
            description="csrc/lowbit_conv.cu: per-CTA patch gather, "
                        "ballot pack, popcount core, epilogue in-kernel",
        )(make(mode, plain=False))
        registry.register(
            mode, "torch", fused=True, layout=registry.LAYOUT_IM2COL,
            epilogue="post-core", compute="torch-popcount",
            description="pack-once activations; packed-word patch gather "
                        "+ chunked popcount",
        )(make(mode, plain=True))


_register_conv_kernels()
