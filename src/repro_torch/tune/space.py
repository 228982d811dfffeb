"""Tuning spaces: the candidate blockings the autotuner may measure.

Counterpart of ``repro/tune/space.py``.  The reference's axes
``(block_m, block_n, block_kw, word_chunk)`` are VMEM tile choices of
its Pallas grid; they do not carry over.  What a caller can choose in
the port:

* ``cta_tile`` — the square CTA tile of a CUDA GeMM kernel, one of the
  tiles compiled into it (``GEMM_TILES`` for the popcount GeMM,
  ``DENSE_TILES`` for the dense tensor-core GeMM, ``AFFINE_TILES`` for
  u8/u4), the counterpart of ``block_m`` / ``block_n`` (``kind="cuda"``);
* ``word_chunk`` — the words per step of the plain PyTorch versions
  (``kind="torch"``, the reference's ``XLA_SPACE``);
* ``seg_bits`` and ``word_chunk`` — the indexed backend's segment width
  and segments per step (``kind="indexed"``, the reference's
  ``INDEXED_SPACE``, whose ``block_kw`` is ``seg_bits`` here).

The conv kernels' tiles are compiled in, so their registry cells
declare no space and the tuner keeps their default plan.

Candidates are *normalized* to what the kernel would actually run (a
``word_chunk`` past the word count runs as the word count; a segment
width rounds down to a supported one) and deduped.  Every candidate
list starts with the default blocking — for the CUDA cells
``gemm_tile``'s choice for the shape — so a tuned plan can never lose to
the untuned choice: at worst the default wins its own bake-off.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

from repro_torch.kernels._matmul_common import (AFFINE_TILES, DENSE_TILES,
                                                GEMM_TILES, TileConfig)

__all__ = ["TuningSpace", "GEMM_SPACE", "DENSE_SPACE", "AFFINE_SPACE",
           "TORCH_SPACE", "AFFINE_TORCH_SPACE", "INDEXED_SPACE", "words_for"]

_SEG_BITS = (8, 4, 2)          # supported segment widths, largest first
_AXES = {"cuda": ("cta_tile",), "torch": ("word_chunk",),
         "indexed": ("seg_bits", "word_chunk")}


def words_for(k: int) -> int:
    """32-bit words covering a logical reduction depth of ``k``."""
    return max(1, -(-k // 32))


@dataclasses.dataclass(frozen=True)
class TuningSpace:
    """Candidate axes for one kernel's blocking; ``kind`` says which
    axes its kernel reads (``_AXES``)."""
    kind: str = "cuda"                       # "cuda" | "torch" | "indexed"
    cta_tile: Tuple[int, ...] = ()
    word_chunk: Tuple[int, ...] = ()
    seg_bits: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.kind not in _AXES:
            raise ValueError(f"unknown TuningSpace kind {self.kind!r}")
        for name in _AXES[self.kind]:
            vals = getattr(self, name)
            if not vals or any(v < 1 for v in vals):
                raise ValueError(f"TuningSpace.{name} must be non-empty "
                                 f"positive ints, got {vals}")

    def normalize(self, tc: TileConfig, m: int, n: int, k: int,
                  kw: Optional[int] = None) -> TileConfig:
        """The blocking the kernel would actually run for this shape —
        the dedupe key that keeps the measured set minimal.  ``kw``
        overrides the word count when it differs from ``words_for(k)``."""
        kw = words_for(k) if kw is None else kw
        if self.kind == "cuda":
            return TileConfig(cta_tile=tc.cta_tile)
        if self.kind == "torch":
            return TileConfig(word_chunk=min(tc.word_chunk, kw))
        b = next((c for c in _SEG_BITS if c <= tc.seg_bits), _SEG_BITS[-1])
        return TileConfig(seg_bits=b, word_chunk=min(tc.word_chunk, kw * (32 // b)))

    def candidates(self, m: int, n: int, k: int, *, default: TileConfig,
                   kw: Optional[int] = None) -> List[TileConfig]:
        """Deduped candidate list for one (m, n, k) problem: ``default``
        first, then the axis product, normalized, in declaration order.
        Deterministic order and an argmin that keeps the earliest of
        equal times make repeated runs pick the same plan."""
        out = [default]
        seen = {self.normalize(default, m, n, k, kw)}
        names = _AXES[self.kind]
        for vals in itertools.product(*(getattr(self, a) for a in names)):
            eff = self.normalize(TileConfig(**dict(zip(names, vals))), m, n, k, kw)
            if eff not in seen:
                seen.add(eff)
                out.append(eff)
        return out


# The spaces the registry cells declare (kernels/ops.py, dense_fused.py,
# indexed_matmul.py).
GEMM_SPACE = TuningSpace(kind="cuda", cta_tile=GEMM_TILES)
DENSE_SPACE = TuningSpace(kind="cuda", cta_tile=DENSE_TILES)
AFFINE_SPACE = TuningSpace(kind="cuda", cta_tile=AFFINE_TILES)
TORCH_SPACE = TuningSpace(kind="torch", word_chunk=(2, 4, 8, 16, 32))
# The plain u8/u4 cells have no blocking of their own (one float64
# product); one candidate, the default, as the reference's AFFINE_SPACE.
AFFINE_TORCH_SPACE = TuningSpace(kind="torch", word_chunk=(8,))
INDEXED_SPACE = TuningSpace(kind="indexed", seg_bits=(2, 4, 8), word_chunk=(8, 16, 32))
