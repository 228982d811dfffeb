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

The statistics themselves, on CUDA operands, are one hand-written kernel
of the same library (``act_stats_kernel``: two passes over the unpadded
input, float64 sums in a fixed order); :func:`conv_act_stats_torch` is its
plain version, which CPU operands take.

Two backends:

* ``"cuda"`` — ``csrc/lowbit_conv.cu`` (replaces the reference's
  ``_conv_pallas_fused``), two kernels on the current stream: the packing
  pass (:func:`conv_pack_cuda`) quantizes each padded input pixel once
  with the device scalar ``thr`` and packs it with ``__ballot_sync``;
  the conv kernel then gathers packed words per CTA (one 4-byte load per
  word, staged with ``cp.async`` and reused across all of Cout), runs the
  popcount core and the eq. (6) / eq. (2) epilogue in-kernel.  The dense
  conv (``dense_fused``) consumes the same planes.  On CPU tensors the
  entry runs the plain version.
* ``"torch"`` — the plain version (counterpart of ``_conv_xla_fused``):
  quantize and pack the padded input once, gather packed words with one
  strided slice per patch position, then the chunked popcount with the
  epilogue.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core.quantize import f32_scalar
from repro_torch.kernels import _build, registry
from repro_torch.kernels._matmul_common import (
    DEFAULT_TILES, PRODUCT_FNS, _MODE_ID, _ptr, check_f32_vec,
    chunked_bitwise_matmul, runs_kernel, scale_epilogue)
from repro_torch.kernels.modes import QuantMode

__all__ = ["conv_out_hw", "conv_spatial_pad", "conv_act_stats",
           "conv_act_stats_torch", "axis_multiplicity", "conv_problem_dims",
           "geom_tag", "im2col_hbm_bytes",
           "conv_weight_planes", "gather_patch_tile",
           "quantize_patch_values", "conv_pack_cuda", "conv_pack_torch",
           "packed_conv_args", "conv_fused_cuda", "conv_fused_torch"]


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
    fused versions write (the plain one and the CUDA packing pass)."""
    b, h, w, _ = x_shape
    kh, kw, cin, _ = geometry
    oh, ow, ph, pw = conv_out_hw(h, w, kh, kw, stride, padding)
    m, k = b * oh * ow, kh * kw * cin
    planes = 1 if mode == QuantMode.BNN else 2
    cw = -(-cin // 32)
    return {"materialized": m * k * 4,
            "fused": b * (h + ph) * (w + pw) * cw * 4 * planes}


def axis_multiplicity(n: int, k: int, stride: int, out: int) -> np.ndarray:
    """How many patches along one axis (``k`` taps, ``stride``, ``out``
    outputs) hold each of the axis' ``n`` padded positions, in closed
    form: the outputs o with o * stride <= p <= o * stride + k - 1.  The
    per-axis table ``act_stats_kernel`` builds (``axis_multiplicity`` in
    ``csrc/lowbit_conv.cu``); :func:`_patch_multiplicity` is the outer
    product of two of them."""
    p = np.arange(n)
    hi = np.minimum(p // stride, out - 1)
    lo = np.where(p < k, 0, (p - k + stride) // stride)
    return np.maximum(hi - lo + 1, 0)


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
    threshold and the masked mean (``{"thr", "scale"}``), each
    padded-input element weighted by its multiplicity in the im2col
    matrix.  Float32 device scalars; nothing here syncs the stream.

    On CUDA operands ``act_stats_kernel`` (counted under
    ``conv_stats_<mode>``; raises on what it does not take), on ``meta``
    its record, on CPU operands the plain version
    :func:`conv_act_stats_torch`.
    """
    with obs.annotate("repro_torch.quantize"):
        x = x.to(torch.float32)
        if runs_kernel(x):
            return _launch_stats(mode, x.contiguous(), kh, kw, stride, padding)
        return conv_act_stats_torch(x, mode, kh, kw, stride, padding)


def conv_act_stats_torch(x: torch.Tensor, mode: QuantMode, kh: int, kw: int,
                         stride: int = 1, padding: str = "SAME"
                         ) -> Dict[str, torch.Tensor]:
    """Plain version of :func:`conv_act_stats`: float32 sums over the
    padded input times the multiplicity map, in one O(|x|) pass per
    statistic; the map is built and copied once per geometry (that copy
    syncs the stream)."""
    xp, (oh, ow) = conv_spatial_pad(x.to(torch.float32), kh, kw, stride, padding)
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
# Plain versions: pack once, gather packed words, chunked popcount
# ---------------------------------------------------------------------------

def conv_pack_torch(mode: QuantMode, x: torch.Tensor, kh: int, kw: int,
                    stride: int, padding: str,
                    stats: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Plain packing pass: the conv's padded input quantized and packed
    along the channel axis, one (B, Hp, Wp, ceil(C/32)) int32 plane for
    BNN, (plus, minus) for TNN/TBN."""
    xp, _ = conv_spatial_pad(x.to(torch.float32), kh, kw, stride, padding)
    return tuple(p.contiguous() for p in _pack_activation_planes(xp, mode, stats))


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
    bsz, h, w, _ = x.shape
    oh, ow, _, _ = conv_out_hw(h, w, kh, kw, stride, padding)
    a_full = conv_pack_torch(mode, x, kh, kw, stride, padding, stats)
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
# The Hopper kernels (csrc/lowbit_conv.cu): pack once, then the conv
# ---------------------------------------------------------------------------

def _check_conv_input(x: torch.Tensor, cin: int) -> None:
    if x.dtype != torch.float32 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"conv kernels need contiguous float32 (B, H, W, "
                         f"Cin), got {x.dtype} {tuple(x.shape)}")
    if x.shape[-1] != cin:
        raise ValueError(f"channel mismatch: x has {x.shape[-1]}, Cin {cin}")


_PACK_KEYS = {mode: f"conv_pack_{mode.value}" for mode in _MODE_ID}
_CONV_KEYS = {mode: f"lowbit_conv_{mode.value}" for mode in _MODE_ID}
_STATS_KEYS = {mode: f"conv_stats_{mode.value}" for mode in _MODE_ID}
# conv_stats_launch's scratch (float64 partial sums and 64-bit partial
# counts of up to STATS_BLOCKS = 1,024 blocks, then two tickets) and its
# largest H + W (STATS_TABLE: the per-axis tables in shared memory)
_STATS_SCRATCH_BYTES = 1024 * 16 + 8
_STATS_TABLE = 8192


def _launch_stats(mode: QuantMode, x: torch.Tensor, kh: int, kw: int,
                  stride: int, padding: str) -> Dict[str, torch.Tensor]:
    """``act_stats_kernel``: pass 1 (mean |A|, thr), then for TNN/TBN pass
    2 (alpha), into one float32 (3,) buffer whose elements are the
    returned scalars.  An empty ``x`` launches it too, over nothing: the
    plain version's NaN mean and thr and zero alpha."""
    bsz, h, w, c = x.shape
    oh, ow, ph, pw = conv_out_hw(h, w, kh, kw, stride, padding)
    if x.numel() >= 2**31:
        raise ValueError("conv stats kernel indexes elements with 32-bit ints")
    if h + w > _STATS_TABLE:
        raise ValueError(f"conv stats kernel takes H + W <= {_STATS_TABLE}, "
                         f"got {h} + {w}")
    out = torch.empty(3, dtype=torch.float32, device=x.device)
    stats = ({"scale": out[0]} if mode == QuantMode.BNN
             else {"thr": out[1], "scale": out[2]})
    if x.is_meta:
        _build.record(_STATS_KEYS[mode], b=bsz, h=h, w=w, c=c, kh=kh, kw=kw,
                      stride=stride, oh=oh, ow=ow)
        return stats
    scratch = torch.empty(_STATS_SCRATCH_BYTES, dtype=torch.uint8, device=x.device)
    _build.launch(
        "conv_stats_launch", _STATS_KEYS[mode], x.get_device(), _MODE_ID[mode],
        x.data_ptr(), bsz, h, w, c, kh, kw, stride, oh, ow, ph // 2, pw // 2,
        scratch.data_ptr(), _STATS_SCRATCH_BYTES, out.data_ptr())
    return stats


def _launch_pack(mode: QuantMode, x: torch.Tensor, kh: int, kw: int,
                 stride: int, padding: str,
                 stats: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    bsz, h, w, c = x.shape
    _check_conv_input(x, c)
    dev = x.get_device()
    thr = None
    if mode != QuantMode.BNN:
        thr = stats["thr"]
        check_f32_vec("thr", thr, 1, dev)
    _, _, ph, pw = conv_out_hw(h, w, kh, kw, stride, padding)
    hp, wp, cw = h + ph, w + pw, -(-c // 32)
    if x.numel() >= 2**31 or bsz * hp * wp * cw >= 2**31 - 256:
        raise ValueError("conv pack kernel indexes elements with 32-bit ints")
    nplanes = 1 if mode == QuantMode.BNN else 2
    planes = tuple(torch.empty((bsz, hp, wp, cw), dtype=torch.int32,
                               device=x.device) for _ in range(nplanes))
    if x.numel() == 0:
        return planes
    if x.is_meta:
        _build.record(_PACK_KEYS[mode], b=bsz, h=h, w=w, c=c, hp=hp, wp=wp)
        return planes
    _build.launch(
        "conv_pack_launch", _PACK_KEYS[mode], dev, _MODE_ID[mode], x.data_ptr(),
        bsz, h, w, c, hp, wp, ph // 2, pw // 2, _ptr(thr), planes[0].data_ptr(),
        planes[-1].data_ptr())
    return planes


def conv_pack_cuda(mode: QuantMode, x: torch.Tensor, kh: int, kw: int,
                   stride: int, padding: str,
                   stats: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Packing pass of both conv kernels: ``conv_pack_kernel`` on CUDA
    operands (raises on anything it does not take), the plain version on
    CPU operands."""
    if not runs_kernel(x, *stats.values()):
        return conv_pack_torch(mode, x, kh, kw, stride, padding, stats)
    return _launch_pack(mode, x, kh, kw, stride, padding, stats)


def packed_conv_args(mode: QuantMode, x: torch.Tensor, b_planes, geometry,
                     stride: int, padding: str,
                     stats: Dict[str, torch.Tensor], col_scale: torch.Tensor,
                     bias: Optional[torch.Tensor]):
    """Check the operands of a conv kernel over packed planes; returns
    (out (m, Cout) float32, the launch's (B, Hp, Wp, Cin, kh, kw, stride,
    OH, OW), words per weight row, scale, col, bias).  Shared by the
    popcount and the dense conv wrappers."""
    kh, kw, cin, cout = geometry
    _check_conv_input(x, cin)
    bsz, h, w, _ = x.shape
    dev = x.get_device()
    oh, ow, ph, pw = conv_out_hw(h, w, kh, kw, stride, padding)
    words = kh * kw * (-(-cin // 32))
    nplanes = 2 if mode == QuantMode.TNN else 1
    if len(b_planes) != nplanes:
        raise ValueError(f"{mode.value} conv takes {nplanes} weight plane(s)")
    for p in b_planes:
        if (p.dtype is not torch.int32 or p.get_device() != dev
                or p.shape != (cout, words) or not p.is_contiguous()):
            raise ValueError(f"weight planes must be contiguous int32 "
                             f"({cout}, {words}) on {x.device}, got {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")
    scale = stats["scale"]
    check_f32_vec("scale", scale, 1, dev)
    check_f32_vec("col_scale", col_scale, cout, dev)
    check_f32_vec("bias", bias, cout, dev)
    m = bsz * oh * ow
    if m >= 2**31:
        raise ValueError("conv kernels index output pixels with 32-bit ints")
    out = torch.empty((m, cout), dtype=torch.float32, device=x.device)
    dims = (bsz, h + ph, w + pw, cin, kh, kw, stride, oh, ow)
    return out, dims, words, scale, col_scale, bias


def _conv_problem(dims, cout: int, words: int) -> Dict[str, int]:
    """A conv kernel's problem as ``_build.record`` keeps it: the launch's
    (B, Hp, Wp, Cin, kh, kw, stride, OH, OW), Cout and the words per
    weight row."""
    bsz, hp, wp, cin, kh, kw, stride, oh, ow = dims
    return dict(b=bsz, hp=hp, wp=wp, cin=cin, kh=kh, kw=kw, stride=stride, oh=oh,
                ow=ow, cout=cout, words=words)


def _launch_conv(mode: QuantMode, x: torch.Tensor, b_planes, geometry,
                 stride: int, padding: str, stats: Dict[str, torch.Tensor],
                 col_scale: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> torch.Tensor:
    kh, kw, cin, cout = geometry
    out, dims, words, scale, col, bias = packed_conv_args(
        mode, x, b_planes, geometry, stride, padding, stats, col_scale, bias)
    bsz, _, _, _, _, _, _, oh, ow = dims
    if out.numel() == 0:
        return out.reshape(bsz, oh, ow, cout)
    a = _launch_pack(mode, x, kh, kw, stride, padding, stats)
    if x.is_meta:
        _build.record(_CONV_KEYS[mode], **_conv_problem(dims, cout, words))
        return out.reshape(bsz, oh, ow, cout)
    _build.launch(
        "lowbit_conv_launch", _CONV_KEYS[mode], x.get_device(), _MODE_ID[mode],
        a[0].data_ptr(), a[-1].data_ptr(), *dims, b_planes[0].data_ptr(),
        b_planes[-1].data_ptr(), cout, words, kh * kw * cin, scale.data_ptr(),
        col.data_ptr(), _ptr(bias), out.data_ptr())
    return out.reshape(bsz, oh, ow, cout)


def conv_fused_cuda(mode: QuantMode, x: torch.Tensor, b_planes, geometry,
                    stride: int, padding: str,
                    stats: Dict[str, torch.Tensor], col_scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused conv -> float32 (B, OH, OW, Cout): on CUDA operands the pack
    kernel then the conv kernel, on the current stream with no host sync
    (raises on anything they do not take); the plain version on CPU
    operands."""
    if not runs_kernel(x, *b_planes, *stats.values(), col_scale, bias):
        return conv_fused_torch(mode, x, b_planes, geometry, stride,
                                padding, stats, col_scale, bias)
    return _launch_conv(mode, x, b_planes, geometry, stride, padding, stats,
                        col_scale, bias)


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
            description="csrc/lowbit_conv.cu: pack each input pixel once "
                        "(ballot), gather packed words per CTA, cp.async "
                        "double buffer, popcount core, epilogue in-kernel",
        )(make(mode, plain=False))
        registry.register(
            mode, "torch", fused=True, layout=registry.LAYOUT_IM2COL,
            epilogue="post-core", compute="torch-popcount",
            description="pack-once activations; packed-word patch gather "
                        "+ chunked popcount",
        )(make(mode, plain=True))


_register_conv_kernels()
