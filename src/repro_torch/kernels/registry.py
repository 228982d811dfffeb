"""Kernel registry: one table from (mode, backend, fused, layout) to the
kernel that implements it, with capability metadata.

Counterpart of ``repro/kernels/registry.py``, same key.  Backends of the
port and their reference counterparts (the low-bit and the affine u8/u4
cells alike):

    port "cuda"   <->  reference "pallas"   hand-written Hopper kernels
    port "torch"  <->  reference "xla"      their plain PyTorch versions
    port "dense"  <->  reference "dense"    planes decoded to +-1/0 on
                                            chip, tensor-core product
    port "indexed" <-> reference "indexed"  RSR subset-sum tables and a
                                            gather per column, plain
                                            PyTorch on any device
                                            (kernels/indexed_matmul.py)

A "cuda" or fused "dense" entry handed CPU tensors runs the plain
version (that is how the CPU tests reach it); handed CUDA tensors it
launches its kernel or raises.  The unfused "dense" cell is the
materializing oracle, plain PyTorch on any device, as the reference's
is a plain XLA dot.

``layout``: ``"gemm"`` — A is an (m, k) activation matrix;
``"im2col_fused"`` — A is the raw (B, H, W, Cin) input and the kernel
gathers patches itself (kernels/conv_fused.py).

Normalized signatures (planes are tuples of int32 bit-plane tensors — 1
for binary operands, 2 (plus, minus) for ternary; for the affine u8/u4
modes the (integer grid, zero point) pair of each operand):

* gemm, unfused: ``fn(a_planes, b_planes, k_valid, *, tiles=None)``
  -> int32 (m, n)
* gemm, fused: ``fn(a_planes, b_planes, k_valid, row_scale, col_scale,
  bias, *, tiles=None)`` -> float32 (m, n)
* im2col_fused: ``fn(x, b_planes, geometry, stride, padding, stats,
  col_scale, bias, *, tiles=None)`` -> float32 (B, OH, OW, Cout)

``tiles`` (a ``TileConfig``) sets the CUDA GeMMs' CTA tile
(``cta_tile``; None: ``gemm_tile``'s choice), the plain versions'
``word_chunk`` and the indexed cells' ``seg_bits``; the conv kernels'
tiles are compiled in.  ``tunable`` is the cell's
``repro_torch.tune.space.TuningSpace`` (the CTA tiles compiled into a
CUDA GeMM, the plain versions' ``word_chunk``, the indexed axes), or
None where nothing can be chosen (the conv cells, the materializing
oracle).  ``ops.qmm`` passes each request the plan cache's blocking
(``repro_torch.tune.cache.plan_for``).  A ``payload_aware`` cell also
takes ``payload=`` (the weight QTensor's payload dict).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.kernels.modes import QuantMode

__all__ = ["KernelSpec", "register", "lookup", "has", "available",
           "backends", "modes", "capability_table", "LAYOUT_GEMM",
           "LAYOUT_IM2COL"]

LAYOUT_GEMM = "gemm"
LAYOUT_IM2COL = "im2col_fused"


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered kernel + the metadata consumers need to pick it."""
    mode: QuantMode
    backend: str              # "cuda" | "torch" | "dense"
    fused: bool               # epilogue included
    fn: Callable
    epilogue: str             # "in-kernel" | "post-core" | "none"
    compute: str              # "cuda-popcount" | "cuda-imma" | "torch-..."
    description: str = ""
    tunable: Optional[Any] = None
    layout: str = LAYOUT_GEMM
    # True when ``fn`` takes ``payload=`` (the weight QTensor's whole
    # payload dict: the indexed cells read its pack-time ``idx`` planes)
    payload_aware: bool = False

    @property
    def key(self) -> Tuple[QuantMode, str, bool, str]:
        return (self.mode, self.backend, self.fused, self.layout)


_REGISTRY: Dict[Tuple[QuantMode, str, bool, str], KernelSpec] = {}


def register(mode: QuantMode, backend: str, *, fused: bool,
             epilogue: str, compute: str, description: str = "",
             tunable: Optional[Any] = None, layout: str = LAYOUT_GEMM,
             payload_aware: bool = False):
    """Decorator: register ``fn`` as THE kernel for (mode, backend, fused,
    layout).  Re-registration overwrites."""

    def deco(fn: Callable) -> Callable:
        spec = KernelSpec(mode=mode, backend=backend, fused=fused, fn=fn,
                          epilogue=epilogue, compute=compute,
                          description=description, tunable=tunable,
                          layout=layout, payload_aware=payload_aware)
        _REGISTRY[spec.key] = spec
        return fn

    return deco


def lookup(mode: QuantMode, backend: str, *, fused: bool,
           layout: str = LAYOUT_GEMM) -> KernelSpec:
    try:
        return _REGISTRY[(mode, backend, fused, layout)]
    except KeyError:
        have = sorted(f"{m.value}/{b}{'/fused' if f else ''}"
                      f"{'/' + lay if lay != LAYOUT_GEMM else ''}"
                      for (m, b, f, lay) in _REGISTRY)
        raise KeyError(
            f"no {'fused ' if fused else ''}kernel registered for "
            f"mode={mode.value} backend={backend!r} layout={layout!r}; "
            f"registered: {have}") from None


def has(mode: QuantMode, backend: str, *, fused: bool,
        layout: str = LAYOUT_GEMM) -> bool:
    return (mode, backend, fused, layout) in _REGISTRY


def available(mode: Optional[QuantMode] = None,
              backend: Optional[str] = None,
              fused: Optional[bool] = None,
              layout: Optional[str] = None) -> List[KernelSpec]:
    """All registered kernels matching the filters, in a stable order."""
    out = [s for s in _REGISTRY.values()
           if (mode is None or s.mode == mode)
           and (backend is None or s.backend == backend)
           and (fused is None or s.fused == fused)
           and (layout is None or s.layout == layout)]
    return sorted(out, key=lambda s: (s.mode.value, s.backend, s.fused,
                                      s.layout))


def backends(mode: Optional[QuantMode] = None) -> List[str]:
    return sorted({s.backend for s in available(mode=mode)})


def modes(backend: Optional[str] = None) -> List[QuantMode]:
    seen = {s.mode for s in available(backend=backend)}
    return sorted(seen, key=lambda m: m.value)


def capability_table() -> str:
    """Human-readable mode x backend x layout x fused table."""
    header = (f"{'mode':>5s} {'backend':>8s} {'layout':>13s} {'fused':>6s} "
              f"{'epilogue':>11s} {'compute':>14s}  description")
    lines = [header, "-" * len(header)]
    for s in available():
        lines.append(f"{s.mode.value:>5s} {s.backend:>8s} {s.layout:>13s} "
                     f"{str(s.fused).lower():>6s} {s.epilogue:>11s} "
                     f"{s.compute:>14s}  {s.description}")
    return "\n".join(lines)
