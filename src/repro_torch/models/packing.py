"""Offline weight packing for LM serving — the paper's Algorithm 2 (pack
B once, offline) applied to a whole parameter tree.

Counterpart of ``repro/models/packing.py``.  ``pack_lm_params`` walks the
tree by path and replaces every projection leaf ``{"w": (..., k, n)}``
whose quantization class (``_CLASS_OF``) is low-bit with a
:class:`~repro_torch.kernels.qtensor.QTensor`:

    tnn:      payload {plus (n, kw), minus (n, kw)}, scale (n,)   8x smaller than bf16
    tbn/bnn:  payload {bits (n, kw)}, scale (n,)                  16x smaller

Period-stacked weights (P, k, n) become ONE stacked container whose
tensors carry the leading (P,) dim while its ``shape`` stays the logical
(k, n) (``QTensor.stack``; the model takes period r with
``QTensor.period``).  Embeddings, norms and the LM head stay as they are.
At serve time ``attention.project`` sees a QTensor leaf and runs one
``ops.qmm`` per projection: decode streams 1/8 (ternary) or 1/16
(binary) of the bf16 weight bytes per token.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import torch

from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.modes import QuantMode
from repro_torch.kernels.qtensor import QTensor

__all__ = ["pack_lm_params", "packed_matmul_any"]


# path -> projection class (mirror of the modules' own policy usage)
_CLASS_OF = (
    (r"(wq|wk|wv|wo)$", "attn_proj"),
    (r"(gate|up|down|shared/(gate|up|down))$", "ffn_proj"),
    (r"(in_proj|out_proj)$", "ssm_proj"),
)


def _pack_leaf(w: torch.Tensor, mode: QuantMode) -> QTensor:
    """w (..., k, n) float -> QTensor, leading dims stacked on its tensors."""
    if w.ndim == 2:
        return QTensor.from_dense(w.to(torch.float32), mode)
    return QTensor.stack([_pack_leaf(ww, mode) for ww in w])


def pack_lm_params(params: Dict[str, Any], cfg,
                   policy: QuantPolicy | None = None) -> Dict[str, Any]:
    """Pack a whole LM parameter tree (see the module docstring) under
    ``policy`` (default ``cfg.policy``); leaves that are not low-bit
    projections are returned as they are (the same tensors).  The
    reference's mesh switch ``shard`` has no counterpart on one card."""
    policy = policy or cfg.policy

    def walk(tree, prefix=""):
        if isinstance(tree, dict) and "w" in tree and tree["w"].ndim >= 2:
            for pat, cls in _CLASS_OF:
                if re.search(pat, prefix):
                    mode = policy.for_class(cls)
                    if mode.is_lowbit:
                        packed = _pack_leaf(tree["w"], mode)
                        if "b" in tree:
                            packed = packed.replace(bias=tree["b"])
                        return packed
                    break
            return tree
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
        return tree

    return walk(params)


def packed_matmul_any(packed: QTensor, x2: torch.Tensor, backend: str) -> torch.Tensor:
    """x2 (m, k) float x packed QTensor -> (m, n) float32: one ``ops.qmm``
    (activation quantization, the core and the scale (+ bias) epilogue;
    mode, depth and epilogue operands from the QTensor)."""
    return ops.qmm(x2.to(torch.float32), packed, backend=backend)
