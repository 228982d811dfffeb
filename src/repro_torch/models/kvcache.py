"""Decode-time state containers: KV caches (full and ring) and SSM
recurrent states, stacked over layer periods.

Counterpart of ``repro/models/kvcache.py``.  Layout per pattern entry
(leading dim = num_periods):

* "A"  (global attention):  k/v (P, B, L, KVp, dh), pos (P, B, L), L = max_len
* "AL" (sliding window):    the same with L = min(window, max_len), a ring
  buffer written at ``step % L``;
* "M"  (SSD):               conv (P, B, K-1, conv_dim), h (P, B, G, Hg, N, Pd)

``pos`` starts at :data:`INVALID_POS` (2**30) so unwritten slots never pass
the ``pos <= step`` mask.  Storage resolves through
:func:`~repro_torch.models.common.kv_cache_format`: ``"bf16"`` and
``"int8"`` build the dense slabs, the paged formats (``"tnn2"``,
``"tnn2-oracle"``) the page-table caches of
:mod:`repro_torch.models.paged_kvcache` with the given page geometry.  An
explicit ``dtype=`` forces the dense slab.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.kernels.modes import DEFAULT_DEVICE, resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import head_layout
from repro_torch.models.common import ModelConfig, ShardLayout, kv_cache_format
from repro_torch.models.paged_kvcache import (INVALID_POS, init_paged_caches,
                                              paged_logical_axes)

__all__ = ["init_caches", "cache_logical_axes", "INVALID_POS"]


def init_caches(cfg: ModelConfig, layout: ShardLayout, batch: int, max_len: int,
                dtype=None, *, page_size: int = 16, prefill_chunk: int = 32,
                device=DEFAULT_DEVICE) -> List[Dict[str, Any]]:
    """Decode caches for one batch on ``device``.  ``dtype=None`` resolves
    the storage from ``cfg.kv_cache_dtype`` (failing loudly on unknown
    names); a paged format hands the page geometry to
    ``init_paged_caches``."""
    dev = resolve_device(device)
    if dtype is None:
        fmt = kv_cache_format(cfg.kv_cache_dtype)
        if fmt.paged:
            return init_paged_caches(cfg, layout, batch, max_len, page_size=page_size,
                                     prefill_chunk=prefill_chunk,
                                     oracle=fmt.storage_dtype is not None, device=dev)
        dtype = fmt.storage_dtype
    hl = head_layout(cfg.num_heads, cfg.num_kv_heads, layout.tp)
    caches = []
    for mixer, _ in cfg.layer_pattern:
        if mixer in ("A", "AL"):
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
        elif mixer == "M":
            st = ssm_mod.init_ssm_state(cfg, batch, device=dev)
            caches.append({k: v[None].repeat((cfg.num_periods,) + (1,) * v.ndim)
                           for k, v in st.items()})
        else:
            raise ValueError(mixer)
    return caches


def cache_logical_axes(cfg: ModelConfig) -> List[Dict[str, Any]]:
    """Logical axes per cache leaf, the leading period dim replicated (the
    reference's); a paged format hands over to ``paged_logical_axes``."""
    if kv_cache_format(cfg.kv_cache_dtype).paged:
        return paged_logical_axes(cfg)
    out = []
    for mixer, _ in cfg.layer_pattern:
        if mixer in ("A", "AL"):
            out.append({
                "k": (None, "batch", None, "kv_heads", None),
                "v": (None, "batch", None, "kv_heads", None),
                "pos": (None, "batch", None),
            })
        else:
            out.append({
                "conv": (None, "batch", None, "conv_dim"),
                "h": (None, "batch", None, "ssm_heads", None, None),
            })
    return out
