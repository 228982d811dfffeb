"""Indexed-redundancy matmul backend (RSR, arXiv 2411.06360), plain PyTorch.

Counterpart of ``repro/kernels/indexed_matmul.py``.  Split the depth axis
into segments of ``b`` bits: every weight column restricted to one
segment is one of ``2**b`` sign patterns.  Per activation row and
segment, build the subset-sum table of all ``2**b`` patterns (``b``
doubling steps), then reduce each column to a table gather keyed by the
segment's pattern index:

* TNN weights: ``T[idx_plus] - T[idx_minus]``;
* binary weights (bit set == -1): ``sum(segment) - 2 * T[idx_bits]``.

Every table entry, gather and sum is int32, so the core is exact and
``array_equal`` to the popcount backends.  The fused entry applies the
same eq. (2) epilogue (``_matmul_common.scale_epilogue``, same multiply
order) as every other backend, so its floats are bit-identical too.

Pack-time preprocessing (:func:`add_indexed_payload`,
``ops.pack_weights(..., indexed_bits=b)``) stores the per-segment
pattern indices as extra QTensor payload keys (``idx{b}_plus`` /
``idx{b}_minus`` for TNN, ``idx{b}_bits`` for TBN/BNN; (n, S) uint8);
containers without them derive the indices from the bit-plane words by
shift and mask (:func:`segment_indices`), bit-identically.

The reference's ``lax.scan`` over chunks of ``seg_chunk`` segments is a
Python loop here.  ``TileConfig.seg_bits`` carries the segment width
where the reference reads ``tiles.block_kw`` (:func:`seg_bits_for`) and
``TileConfig.word_chunk`` the segments per step.  This is no port of a
TPU kernel (the reference has none here): it runs as plain PyTorch on
whatever device its operands lie on.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import encoding
from repro_torch.kernels import registry
from repro_torch.kernels._matmul_common import (DEFAULT_TILES, TileConfig,
                                                scale_epilogue)
from repro_torch.kernels.modes import QuantMode
# The tuning axes of these cells: the segment width in bits (the
# reference's ``block_kw``) and the segments per step (``word_chunk``).
from repro_torch.tune.space import INDEXED_SPACE

__all__ = ["SEG_BITS_CHOICES", "INDEXED_SPACE", "seg_bits_for",
           "indexed_payload_keys", "segment_indices", "add_indexed_payload",
           "indexed_matmul", "indexed_matmul_fused"]

# Segment widths: divisors of 32, so a segment never straddles a word.
SEG_BITS_CHOICES = (8, 4, 2)



def seg_bits_for(tiles: Optional[TileConfig]) -> int:
    """Segment width of a blocking: the largest supported ``b <=
    tiles.seg_bits`` (8 for the default blocking)."""
    want = (tiles or TileConfig()).seg_bits
    for b in SEG_BITS_CHOICES:
        if b <= want:
            return b
    return SEG_BITS_CHOICES[-1]


def indexed_payload_keys(mode: QuantMode, seg_bits: int) -> Tuple[str, ...]:
    """Payload keys of the pack-time segment indices for (mode, seg_bits),
    one per weight bit plane."""
    if mode == QuantMode.TNN:
        return (f"idx{seg_bits}_plus", f"idx{seg_bits}_minus")
    if mode in (QuantMode.TBN, QuantMode.BNN):
        return (f"idx{seg_bits}_bits",)
    raise ValueError(f"indexed payload is only defined for the bit-plane "
                     f"modes, got {mode}")


def segment_indices(words: torch.Tensor, seg_bits: int) -> torch.Tensor:
    """Per-segment pattern indices of (n, kw) packed words (int32 holding
    uint32 bits, LSB first) -> (n, kw * 32 // seg_bits) uint8: entry ``s``
    of word ``w`` is ``(word >> (s * seg_bits)) & (2**seg_bits - 1)``."""
    if seg_bits not in SEG_BITS_CHOICES:
        raise ValueError(f"seg_bits must be one of {SEG_BITS_CHOICES}, "
                         f"got {seg_bits}")
    spw = 32 // seg_bits
    shifts = torch.arange(spw, dtype=torch.int32, device=words.device) * seg_bits
    segs = (words.to(torch.int32)[:, :, None] >> shifts) & ((1 << seg_bits) - 1)
    return segs.reshape(words.shape[0], -1).to(torch.uint8)


def add_indexed_payload(qt, seg_bits: int = 8):
    """``qt`` with the segment indices of its weight planes added as the
    ``idx{b}_*`` payload keys (derived data: ``to_legacy_dict`` drops them
    and the kernel re-derives them when absent)."""
    from repro_torch.kernels.qtensor import PAYLOAD_KEYS

    keys = indexed_payload_keys(qt.mode, seg_bits)   # validates the mode
    planes = [qt.payload[k] for k in PAYLOAD_KEYS[qt.mode]]
    extra = {ik: segment_indices(pl, seg_bits) for ik, pl in zip(keys, planes)}
    return qt.replace(payload={**qt.payload, **extra})


def _activation_values(mode: QuantMode, a_planes, k: int, depth: int) -> torch.Tensor:
    """Activation planes -> +-1/0 int32 values, zero past ``k`` up to the
    packed ``depth``: pad values add nothing to any subset sum."""
    if mode == QuantMode.BNN:
        vals = encoding.unpack_binary(a_planes[0], k, torch.int32)
    else:
        vals = encoding.unpack_ternary(a_planes[0], a_planes[1], k, torch.int32)
    return F.pad(vals, (0, depth - k))


def _gather_tables(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tables (m, C, P) int32, idx (n, C) -> (m, n) int32: the sum over the
    C segments of each column's table entry."""
    m, c, p = tables.shape
    flat = idx.to(torch.int64) + torch.arange(c, device=idx.device) * p   # (n, C)
    g = tables.reshape(m, c * p).index_select(1, flat.reshape(-1))
    return g.reshape(m, idx.shape[0], c).sum(dim=-1, dtype=torch.int32)


def _indexed_core(mode: QuantMode, a_planes, b_planes, k: int, *, seg_bits: int,
                  seg_chunk: int, payload: Optional[Dict[str, torch.Tensor]] = None
                  ) -> torch.Tensor:
    """acc[m, n] int32, summed over chunks of ``seg_chunk`` segments.
    ``payload`` may carry the pack-time ``idx{b}_*`` planes; without them
    the indices are derived from ``b_planes``."""
    kw = int(b_planes[0].shape[-1])
    depth = kw * 32
    nseg = kw * (32 // seg_bits)

    keys = indexed_payload_keys(mode, seg_bits)
    if payload is not None and all(kk in payload for kk in keys):
        idx_planes: Sequence[torch.Tensor] = [payload[kk] for kk in keys]
    else:
        idx_planes = [segment_indices(pl, seg_bits) for pl in b_planes]

    a_vals = _activation_values(mode, a_planes, int(k), depth)
    m, n = a_vals.shape[0], idx_planes[0].shape[0]
    chunk = max(1, min(int(seg_chunk), nseg))
    nseg_p = -(-nseg // chunk) * chunk
    a_seg = F.pad(a_vals, (0, (nseg_p - nseg) * seg_bits)).reshape(m, nseg_p, seg_bits)
    idx_p = [F.pad(ix.to(torch.int32), (0, nseg_p - nseg)) for ix in idx_planes]

    acc = torch.zeros((m, n), dtype=torch.int32, device=a_vals.device)
    for s0 in range(0, nseg_p, chunk):
        a_ch = a_seg[:, s0:s0 + chunk]                        # (m, chunk, b)
        # subset-sum table by LSB-first doubling: entry p sums the values
        # whose pattern bit is set in p
        tables = torch.zeros((m, chunk, 1), dtype=torch.int32, device=acc.device)
        for t in range(seg_bits):
            tables = torch.cat([tables, tables + a_ch[:, :, t:t + 1]], dim=-1)
        if mode == QuantMode.TNN:
            acc += (_gather_tables(tables, idx_p[0][:, s0:s0 + chunk])
                    - _gather_tables(tables, idx_p[1][:, s0:s0 + chunk]))
        else:
            total = a_ch.sum(dim=(1, 2), dtype=torch.int32)   # (m,)
            acc += total[:, None] - 2 * _gather_tables(tables, idx_p[0][:, s0:s0 + chunk])
    return acc


def indexed_matmul(mode: QuantMode, a_planes, b_planes, k: int, *, seg_bits: int = 8,
                   seg_chunk: int = 8,
                   payload: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Unfused integer core: packed planes -> int32 (m, n), equal to the
    popcount backends'."""
    return _indexed_core(mode, a_planes, b_planes, k, seg_bits=seg_bits,
                         seg_chunk=seg_chunk, payload=payload)


def indexed_matmul_fused(mode: QuantMode, a_planes, b_planes, k: int, row_scale,
                         col_scale, bias=None, *, seg_bits: int = 8, seg_chunk: int = 8,
                         payload: Optional[Dict[str, torch.Tensor]] = None
                         ) -> torch.Tensor:
    """The core and the eq. (2) epilogue -> float32 (m, n)."""
    acc = _indexed_core(mode, a_planes, b_planes, k, seg_bits=seg_bits,
                        seg_chunk=seg_chunk, payload=payload)
    return scale_epilogue(acc, row_scale, col_scale, bias)


def _register_indexed_kernels():
    def make(mode, fused):
        def blocking(tiles):
            t = tiles or DEFAULT_TILES[mode.value]
            return {"seg_bits": seg_bits_for(t), "seg_chunk": t.word_chunk}

        def unfused_fn(a, b, k, *, tiles=None, payload=None):
            return indexed_matmul(mode, a, b, k, payload=payload, **blocking(tiles))

        def fused_fn(a, b, k, r, c, bias, *, tiles=None, payload=None):
            return indexed_matmul_fused(mode, a, b, k, r, c, bias, payload=payload,
                                        **blocking(tiles))

        return fused_fn if fused else unfused_fn

    for mode in (QuantMode.BNN, QuantMode.TNN, QuantMode.TBN):
        for fused in (False, True):
            registry.register(
                mode, "indexed", fused=fused,
                epilogue="post-core" if fused else "none",
                compute="torch-indexed", tunable=INDEXED_SPACE, payload_aware=True,
                description="RSR segment-index gather: 2^b subset-sum tables "
                            "replace per-column popcounts"
                            + ("; eq. (2) epilogue" if fused else ""),
            )(make(mode, fused))


_register_indexed_kernels()
