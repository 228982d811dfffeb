"""Shape specs and the (arch x shape) cell grid.

Each architecture is paired with the LM shape set:

* ``train_4k``     seq 4096,   global batch 256  -> lowers train_step
* ``prefill_32k``  seq 32768,  global batch 32   -> lowers prefill
* ``decode_32k``   seq 32768,  global batch 128  -> lowers serve_step
                   (one new token against a 32k KV cache)
* ``long_500k``    seq 524288, global batch 1    -> serve_step, only for
                   sub-quadratic archs (SSM / hybrid / SWA); skipped for
                   pure full-attention archs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["ShapeSpec", "SHAPES", "applicable_shapes", "SUBQUADRATIC"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k",    4096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524288, 1,   "decode"),
}

# Archs whose decode state is bounded (SSM O(1), hybrid with bounded KV,
# SWA ring buffer) — the only ones long_500k runs for.
SUBQUADRATIC = frozenset({"mamba2-1.3b", "jamba-1.5-large-398b",
                          "mixtral-8x22b"})


def applicable_shapes(arch: str) -> Tuple[str, ...]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in SUBQUADRATIC:
        names.append("long_500k")
    return tuple(names)
