"""QTensor — the container for offline-packed quantized matrices.

Counterpart of ``repro/kernels/qtensor.py`` as a plain frozen dataclass of
tensors: the packed ``payload`` (bit planes for BNN/TBN/TNN as int32
tensors holding uint32 bits, the integer grid for u8/u4, the dense matrix
for the float modes), the dequantization ``scale`` and the optional
``bias`` / affine ``zero``, plus the ``mode``, logical ``shape`` (k, n),
conv ``geometry`` and ``layout`` tag.

Payload keys by mode (weights stored transposed, (n, kw) words)::

    tnn            {"plus", "minus"}   2-bit planes, (n, kw) int32
    tbn / bnn      {"bits"}            1-bit plane,  (n, kw) int32
    int8 / int4    {"q"}               (k, n) int32-valued grid
    f32 / bf16     {"w"}               (k, n) dense

Conv-packed low-bit weights whose ``Cin % 32 != 0`` also carry the
*positional* planes of ``POS_PAYLOAD_KEYS``: each patch position packs
its Cin channels into its own word-aligned run, the layout the
implicit-im2col conv kernel streams.

Stacked containers: a projection of an LM's period-stacked layers packs
into ONE QTensor whose payload, scale, bias and zero carry a leading
``(num_periods,)`` dim while ``shape`` stays the logical 2-D (k, n) — as
the reference's vmapped ``_pack_leaf`` builds it; MoE expert weights
carry two, ``(num_periods, num_experts)``.  :meth:`QTensor.stack` makes
one from per-period (or per-expert) containers and :meth:`QTensor.period`
takes entry ``r`` of the leading dim back out (views, no copy): the one
way the port's model code reads a stacked projection, a period of it
first, then an expert.

Not ported: the reference's mesh ``pspec`` (sharded serving comes with a
later slice of the port).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels.modes import QuantMode, accumulator_bound

__all__ = ["QTensor", "PAYLOAD_KEYS", "POS_PAYLOAD_KEYS", "LAYOUT_BITPLANE",
           "LAYOUT_AFFINE", "LAYOUT_DENSE"]

LAYOUT_BITPLANE = "bitplane32"   # 32-bit words, 32 depth elements per word
LAYOUT_AFFINE = "affine"         # integer grid + scale/zero (eq. (1)-(3))
LAYOUT_DENSE = "dense"           # float passthrough (f32 / bf16)

PAYLOAD_KEYS: Dict[QuantMode, Tuple[str, ...]] = {
    QuantMode.TNN: ("plus", "minus"),
    QuantMode.TBN: ("bits",),
    QuantMode.BNN: ("bits",),
    QuantMode.INT8: ("q",),
    QuantMode.INT4: ("q",),
    QuantMode.F32: ("w",),
    QuantMode.BF16: ("w",),
}

POS_PAYLOAD_KEYS: Dict[QuantMode, Tuple[str, ...]] = {
    QuantMode.TNN: ("pos_plus", "pos_minus"),
    QuantMode.TBN: ("pos_bits",),
    QuantMode.BNN: ("pos_bits",),
}


def _positional_conv_planes(vals_t: torch.Tensor, mode: QuantMode,
                            geometry: Tuple[int, int, int, int]
                            ) -> Dict[str, torch.Tensor]:
    """Per-patch-position word view of (n, k) quantized values: position
    p's Cin channels pack into their own word-aligned run."""
    from repro_torch.core import encoding

    kh, kw, cin, _ = geometry
    n = vals_t.shape[0]
    v3 = vals_t.reshape(n, kh * kw, cin)
    if mode == QuantMode.TNN:
        return {"pos_plus": encoding.pack_bits(v3 > 0).reshape(n, -1),
                "pos_minus": encoding.pack_bits(v3 < 0).reshape(n, -1)}
    return {"pos_bits": encoding.pack_bits(v3 < 0).reshape(n, -1)}


def _check_depth(mode: QuantMode, k: int) -> None:
    bound = accumulator_bound(mode)
    if bound is not None and k > bound:
        raise ValueError(
            f"reduction depth k={k} exceeds the {mode.value} accumulator "
            f"bound of {bound} (modes.accumulator_bound): the narrowest "
            f"kernel accumulator for this mode would overflow at "
            f"inference; split the contraction instead of packing it whole")


@dataclasses.dataclass(frozen=True, eq=False)
class QTensor:
    """An offline-quantized matrix: packed payload + epilogue operands as
    tensors, mode / logical shape / geometry as plain fields."""

    payload: Dict[str, torch.Tensor]
    scale: Optional[torch.Tensor]            # per-channel (n,) or scalar
    mode: QuantMode
    shape: Tuple[int, int]                   # logical (k, n)
    bias: Optional[torch.Tensor] = None      # (n,) epilogue bias
    zero: Optional[torch.Tensor] = None      # affine zero point (u8/u4)
    geometry: Optional[Tuple[int, int, int, int]] = None  # (kh,kw,cin,cout)
    layout: str = LAYOUT_BITPLANE

    @property
    def k_valid(self) -> int:
        """Logical reduction depth (the paper's k)."""
        return self.shape[0]

    @property
    def out_features(self) -> int:
        return self.shape[1]

    @property
    def is_lowbit(self) -> bool:
        return self.mode.is_lowbit

    @property
    def device(self) -> torch.device:
        return next(iter(self.payload.values())).device

    def replace(self, **kw) -> "QTensor":
        return dataclasses.replace(self, **kw)

    @property
    def stacked(self) -> bool:
        """True when the tensors carry leading period (or expert) dims
        (the payload has more dims than the 2-D planes / grid / matrix)."""
        return next(iter(self.payload.values())).ndim > 2

    @classmethod
    def stack(cls, parts) -> "QTensor":
        """One stacked container from per-period ones of equal mode,
        shape, geometry and layout: every tensor gains a leading dim."""
        first = parts[0]
        for p in parts[1:]:
            if (p.mode, p.shape, p.geometry, p.layout) != (
                    first.mode, first.shape, first.geometry, first.layout):
                raise ValueError(f"cannot stack {p!r} onto {first!r}")

        def st(get):
            vals = [get(p) for p in parts]
            return None if vals[0] is None else torch.stack(vals)

        return first.replace(
            payload={k: torch.stack([p.payload[k] for p in parts]) for k in first.payload},
            scale=st(lambda p: p.scale), bias=st(lambda p: p.bias),
            zero=st(lambda p: p.zero))

    def period(self, r: int) -> "QTensor":
        """Entry ``r`` of a stacked container's leading dim (a period, or
        an expert): the container one dim down, its tensors views into
        this one's."""
        if not self.stacked:
            raise ValueError(f"{self!r} is not stacked over periods")

        def at(t):
            return None if t is None else t[r]

        return self.replace(payload={k: v[r] for k, v in self.payload.items()},
                            scale=at(self.scale), bias=at(self.bias), zero=at(self.zero))

    def tensors(self):
        """Every tensor the container holds (payload, scale, bias, zero)."""
        out = list(self.payload.values())
        return out + [t for t in (self.scale, self.bias, self.zero)
                      if t is not None]

    def to(self, device) -> "QTensor":
        """The same container with every tensor on ``device``."""
        def mv(t):
            return None if t is None else t.to(device)
        return self.replace(payload={k: v.to(device)
                                     for k, v in self.payload.items()},
                            scale=mv(self.scale), bias=mv(self.bias),
                            zero=mv(self.zero))

    def __repr__(self) -> str:
        geo = f", geometry={self.geometry}" if self.geometry else ""
        return (f"QTensor({self.mode.value}, shape={self.shape}, "
                f"layout={self.layout!r}, payload={sorted(self.payload)}"
                f"{geo})")

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_dense(cls, w: torch.Tensor, mode: QuantMode, *,
                   per_channel: bool = True,
                   bias: Optional[torch.Tensor] = None,
                   geometry: Optional[Tuple[int, int, int, int]] = None,
                   ) -> "QTensor":
        """Offline packing of a dense (k, n) float matrix (Algorithm 2's
        PackedB) on ``w``'s device.

        TNN packs two ternary planes with TWN statistics (threshold
        0.7 * mean|w|, scale the mean |w| above it), TBN/BNN one binary
        plane with scale mean|w| — per output channel unless
        ``per_channel=False``; INT8/INT4 an affine grid; F32/BF16 the
        matrix itself.  Low-bit conv weights (``geometry`` given) whose
        ``cin % 32 != 0`` also store the positional planes.
        """
        from repro_torch.core import encoding, quantize

        k, n = w.shape
        shape = (int(k), int(n))
        _check_depth(mode, shape[0])
        if mode in (QuantMode.F32, QuantMode.BF16):
            dt = torch.float32 if mode == QuantMode.F32 else torch.bfloat16
            return cls(payload={"w": w.to(dt)}, scale=None, mode=mode,
                       shape=shape, bias=bias, geometry=geometry,
                       layout=LAYOUT_DENSE)
        w = w.to(torch.float32)
        dim = 0 if per_channel else None
        pos = geometry is not None and geometry[2] % 32 != 0
        if mode == QuantMode.TNN:
            thr = 0.7 * quantize.mean_abs(w, dim=dim, keepdim=True)
            mask = w.abs() > thr
            t = torch.sign(w) * mask
            if dim is None:
                denom = mask.sum().clamp(min=1)
                total = (w.abs() * mask).sum()
            else:
                denom = mask.sum(dim=dim).clamp(min=1)
                total = (w.abs() * mask).sum(dim=dim)
            scale = total / denom.to(torch.float32)
            plus, minus = encoding.pack_ternary(t.t())
            payload = {"plus": plus, "minus": minus}
            if pos:
                payload.update(_positional_conv_planes(t.t(), mode, geometry))
            return cls(payload=payload, scale=scale, mode=mode, shape=shape,
                       bias=bias, geometry=geometry)
        if mode in (QuantMode.TBN, QuantMode.BNN):
            scale = quantize.mean_abs(w, dim=dim)
            payload = {"bits": encoding.pack_binary(w.t())}
            if pos:
                payload.update(_positional_conv_planes(w.t(), mode, geometry))
            return cls(payload=payload, scale=scale, mode=mode, shape=shape,
                       bias=bias, geometry=geometry)
        if mode in (QuantMode.INT8, QuantMode.INT4):
            q = quantize.affine_calibrate(w, 8 if mode == QuantMode.INT8 else 4)
            return cls(payload={"q": quantize.affine_quantize(w, q)},
                       scale=q.scale, zero=q.zero_point, mode=mode,
                       shape=shape, bias=bias, geometry=geometry,
                       layout=LAYOUT_AFFINE)
        raise ValueError(mode)

    @classmethod
    def from_legacy_dict(cls, d: Dict[str, Any], mode: QuantMode, *,
                         k_valid: Optional[int] = None) -> "QTensor":
        """Convert the anonymous packed dict of earlier revisions
        ({"bits"/"plus"/"minus"/"q", "scale", optional "b"/"zero"/
        "geometry"}); ``k_valid`` is required for bit-plane modes unless
        the dict carries conv "geometry"."""
        d = dict(d)
        geometry = d.pop("geometry", None)
        bias = d.pop("b", None)
        zero = d.pop("zero", None)
        scale = d.pop("scale", None)
        if geometry is not None:
            geometry = tuple(int(g) for g in geometry)
            kh, kw_, cin, _ = geometry
            k_valid = k_valid if k_valid is not None else kh * kw_ * cin
        if mode in (QuantMode.F32, QuantMode.BF16):
            w = d["w"]
            return cls(payload={"w": w}, scale=scale, mode=mode,
                       shape=(int(w.shape[-2]), int(w.shape[-1])),
                       bias=bias, geometry=geometry, layout=LAYOUT_DENSE)
        if mode in (QuantMode.INT8, QuantMode.INT4):
            q = d["q"]
            return cls(payload={"q": q}, scale=scale, zero=zero, mode=mode,
                       shape=(int(q.shape[-2]), int(q.shape[-1])),
                       bias=bias, geometry=geometry, layout=LAYOUT_AFFINE)
        if not mode.is_lowbit:
            raise ValueError(mode)
        if k_valid is None:
            raise ValueError(
                "legacy packed dicts do not record the logical depth; pass "
                "k_valid= (or include conv geometry) when migrating")
        keys = PAYLOAD_KEYS[mode]
        missing = [k for k in keys if k not in d]
        if missing:
            raise KeyError(f"legacy dict for {mode} is missing {missing}")
        payload = {k: d[k] for k in keys}
        n = payload[keys[0]].shape[-2]
        return cls(payload=payload, scale=scale, mode=mode,
                   shape=(int(k_valid), int(n)), bias=bias,
                   geometry=geometry)

    # -- conversions --------------------------------------------------------

    def to_legacy_dict(self) -> Dict[str, Any]:
        """Inverse of :meth:`from_legacy_dict`; positional conv planes are
        derived data the legacy format never stored, so they are dropped
        (``conv_fused.conv_weight_planes`` re-derives them exactly)."""
        out: Dict[str, Any] = {k: self.payload[k]
                               for k in PAYLOAD_KEYS[self.mode]}
        if self.scale is not None:
            out["scale"] = self.scale
        if self.bias is not None:
            out["b"] = self.bias
        if self.zero is not None:
            out["zero"] = self.zero
        if self.geometry is not None:
            out["geometry"] = self.geometry
        return out

    def to_dense(self, dtype=torch.float32) -> torch.Tensor:
        """Dequantize back to the (k, n) float matrix this approximates."""
        from repro_torch.core import encoding

        k, _ = self.shape
        if self.layout == LAYOUT_DENSE:
            return self.payload["w"].to(dtype)
        if self.layout == LAYOUT_AFFINE:
            q = self.payload["q"].to(torch.float32)
            return ((q - self.zero) * self.scale).to(dtype)
        if self.mode == QuantMode.TNN:
            vals = encoding.unpack_ternary(self.payload["plus"],
                                           self.payload["minus"], k)
        else:
            vals = encoding.unpack_binary(self.payload["bits"], k)
        scale = 1.0 if self.scale is None else self.scale.to(torch.float32)
        return (vals.t() * scale).to(dtype)

    def nbytes(self) -> int:
        """Total packed bytes (payload + epilogue operands)."""
        return sum(t.numel() * t.element_size() for t in self.tensors())
