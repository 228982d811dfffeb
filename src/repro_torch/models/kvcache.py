"""Decode-time KV caches, stacked over layer periods.

Counterpart of ``repro/models/kvcache.py`` for the dense slab caches.
Layout per pattern entry (leading dim = num_periods):

* "A"  (global attention):  k/v (P, B, L, KVp, dh), pos (P, B, L), L = max_len
* "AL" (sliding window):    the same with L = min(window, max_len), a ring
  buffer written at ``step % L``.

``pos`` starts at :data:`INVALID_POS` (2**30) so unwritten slots never pass
the ``pos <= step`` mask.  Storage resolves through
:func:`~repro_torch.models.common.kv_cache_format`: ``"bf16"`` and
``"int8"`` build the dense slabs; the paged formats (``"tnn2"``,
``"tnn2-oracle"``) and the SSM states of "M" mixers raise until
``paged_kvcache`` and the SSM are ported.  An explicit ``dtype=`` forces
the dense slab.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.kernels.modes import DEFAULT_DEVICE, resolve_device
from repro_torch.models.attention import head_layout
from repro_torch.models.common import ModelConfig, ShardLayout, kv_cache_format

__all__ = ["init_caches", "INVALID_POS"]

# position of a never-written slot (the reference's paged_kvcache value)
INVALID_POS = 2 ** 30

_LATER = ("not ported yet (ROADMAP.md queue 1: MoE, SSM and the paged cache)")


def init_caches(cfg: ModelConfig, layout: ShardLayout, batch: int, max_len: int,
                dtype=None, *, device=DEFAULT_DEVICE) -> List[Dict[str, Any]]:
    """Decode caches for one batch on ``device``.  ``dtype=None`` resolves
    the storage from ``cfg.kv_cache_dtype`` (failing loudly on unknown
    names)."""
    dev = resolve_device(device)
    if dtype is None:
        fmt = kv_cache_format(cfg.kv_cache_dtype)
        if fmt.paged:
            raise NotImplementedError(f"kv_cache_dtype {fmt.name!r}: the paged "
                                      f"cache is {_LATER}")
        dtype = fmt.storage_dtype
    hl = head_layout(cfg.num_heads, cfg.num_kv_heads, layout.tp)
    caches = []
    for mixer, _ in cfg.layer_pattern:
        if mixer == "M":
            raise NotImplementedError(f"SSM decode states are {_LATER}")
        if mixer not in ("A", "AL"):
            raise ValueError(mixer)
        length = max_len
        if mixer == "AL" and cfg.sliding_window:
            length = min(cfg.sliding_window, max_len)
        shape = (cfg.num_periods, batch, length, hl.kvp, cfg.head_dim_)
        caches.append({
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.full((cfg.num_periods, batch, length), INVALID_POS,
                              dtype=torch.int32, device=dev),
        })
    return caches

