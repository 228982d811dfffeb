"""Error-feedback int8 gradient compression for the data-parallel
all-reduce.

Counterpart of ``repro/optim/compression.py``.  Each gradient leaf is
compressed to int8 with a per-leaf absmax scale before the reduce and
decompressed after, with **error feedback** (Seide et al.; Karimireddy
et al. 2019): the quantization residual is carried to the next step, so
the compressed direction is unbiased in the long run.

On one card there is no all-reduce, but the train step runs the round
trip all the same, as the reference's does: it changes the numbers, and
a run with ``ef_compression`` must take the same steps on one card as on
many.  ``scale = max / 127`` is a division, as in the reference run
eagerly (under ``jax.jit`` XLA turns it into a product with 1/127).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["compress_int8", "decompress_int8", "ef_state_init",
           "ef_compress_update"]


def compress_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """``x`` as int8 with one absmax scale; ``amax`` (the whole leaf's, on
    a mesh where ``x`` is a shard) overrides the max of ``x``'s own."""
    if amax is None:
        amax = torch.amax(torch.abs(x))
    scale = amax / 127.0
    q = torch.round(x / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return {"q": q, "scale": scale}


def decompress_int8(c: Dict[str, torch.Tensor]) -> torch.Tensor:
    return c["q"].to(torch.float32) * c["scale"]


def ef_state_init(grads) -> Any:
    """Zero float32 error buffers shaped like ``grads`` (or the params)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads)


@torch.no_grad()
def ef_compress_update(grads, err, mesh=None) -> Tuple[Any, Any]:
    """-> (compressed-then-decompressed grads, new error state).  On the
    training mesh (``mesh``; ``grads`` and ``err`` this rank's shards) each
    leaf's scale is the whole leaf's: the shards' maxima go through one
    all-reduce (max) over the mesh (the copies of a shard on other ranks
    are equal, so they do not move it), and each element rounds as on one
    device."""
    amax = None
    if mesh is not None:
        # a first pass for the maxima (each sum made again below, so no
        # second copy of the gradients is held)
        amax = [torch.amax(torch.abs(g.to(torch.float32) + e))
                for g, e in zip(tree_leaves(grads), tree_leaves(err))]
        amax = iter(mesh.all_reduce_(torch.stack(amax), "max").unbind(0)) if amax else None

    def leaf(g, e):
        corrected = g.to(torch.float32) + e
        deq = decompress_int8(compress_int8(corrected, None if amax is None else next(amax)))
        return deq, corrected - deq

    out = tree_map(leaf, grads, err)
    return (tree_map(lambda _g, o: o[0], grads, out),
            tree_map(lambda _g, o: o[1], grads, out))
