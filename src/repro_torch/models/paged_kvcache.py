"""Paged KV cache storing K/V in the paper's 2-bit ternary encoding.

Counterpart of ``repro/models/paged_kvcache.py``.  A page pool plus a
per-slot page table replaces the dense slab of ``models/kvcache.py``;
each cached token's K (and V) vector is TWN-quantized at append time
(threshold ``0.7 * mean|x|``, scale the mean of ``|x|`` above it, per
token), packed into ``(plus, minus)`` words along the head dim and
decoded on read as ``alpha * (plus - minus)``: the eq. (2) scale
epilogue applied to cache reads.

Layout per attention pattern entry (leading dim = num_periods; the
model takes period r of every leaf, a view)::

    packed ("tnn2"):
      k_plus/k_minus/v_plus/v_minus  (P, n_pages, page, KVp, dw)  int32 (uint32 bits)
      k_scale/v_scale                (P, n_pages, page)           float32
      pos                            (P, n_pages, page)  int32 = INVALID_POS
      page_table                     (P, B, npp)         int32 = 0
    oracle ("tnn2-oracle"): the same indirection with bf16 k/v pages
      k/v                            (P, n_pages, page, KVp, dh)  bfloat16

with ``dw = packed_width(head_dim)``.  Page 0 is a reserved scratch
page: unallocated table entries point at it and every dead token (chunk
padding, inactive rows) is written there with ``INVALID_POS``, so no
mask ever accepts its content.  The free list hands out pages
1..n_pages-1; :class:`PageAllocator` keeps exact accounting.

Sliding-window ("AL") entries keep a ring of pages: logical position
``p`` lives at slot ``p % (npp * page)``, and the ring holds
``window + prefill_chunk - 1`` positions (page-rounded), so a
write-then-attend chunk never overwrites a key that one of its own
queries still needs.

Pages are written in place.  ``PageAllocator.alloc`` passes the
``pages.exhausted`` fault point (``repro_torch.resilience.faults``), as
the reference's does.  Not ported: the mesh axes beyond one card
(:func:`paged_logical_axes` keeps the names).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.encoding import pack_ternary, packed_width, unpack_bits
from repro_torch.kernels.modes import DEFAULT_DEVICE, resolve_device
from repro_torch.models.common import ModelConfig, ShardLayout
from repro_torch.resilience import faults

__all__ = [
    "INVALID_POS", "SCRATCH_PAGE", "is_paged", "entry_geometry",
    "init_paged_caches", "paged_logical_axes", "ternarize_tokens",
    "append_tokens", "page_view", "PageAllocator", "PagePoolExhausted",
    "EntryPager", "make_pagers", "sync_page_tables", "reset_pages",
    "tree_nbytes",
]


class PagePoolExhausted(RuntimeError):
    """Page allocation failed: not enough free pages for the request (a
    typed subclass, so a scheduler can catch exhaustion alone)."""


INVALID_POS = 2 ** 30
SCRATCH_PAGE = 0


def is_paged(entry: Any) -> bool:
    """True for a paged cache entry (it has a page table)."""
    return isinstance(entry, dict) and "page_table" in entry


def entry_geometry(entry) -> Tuple[int, int, int]:
    """(n_pages, page, npp) from leaf shapes, with or without the leading
    period dim."""
    npp = entry["page_table"].shape[-1]
    n_pages, page = entry["pos"].shape[-2:]
    return n_pages, page, npp


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def init_paged_caches(cfg: ModelConfig, layout: ShardLayout, batch: int, max_len: int, *,
                      page_size: int = 16, prefill_chunk: int = 32, oracle: bool = False,
                      device=DEFAULT_DEVICE) -> List[Dict[str, Any]]:
    """Paged caches for every pattern entry (attention mixers only) on
    ``device``."""
    from repro_torch.models.attention import head_layout   # attention imports us

    if any(m == "M" for m, _ in cfg.layer_pattern):
        raise NotImplementedError(
            "paged (tnn2) KV caches cover attention mixers only; pattern "
            f"{cfg.layer_pattern} has an SSM ('M') entry whose recurrent "
            "state has no page structure — serve it with a dense cache")
    if page_size < 1 or prefill_chunk < 1:
        raise ValueError(f"page_size={page_size} / prefill_chunk="
                         f"{prefill_chunk} must be >= 1")
    dev = resolve_device(device)
    hl = head_layout(cfg.num_heads, cfg.num_kv_heads, layout.tp)
    dh = cfg.head_dim_
    p_dim = cfg.num_periods
    caches: List[Dict[str, Any]] = []
    for mixer, _ in cfg.layer_pattern:
        cap = max_len
        if mixer == "AL" and cfg.sliding_window:
            cap = min(cfg.sliding_window + prefill_chunk - 1, max_len)
        npp = -(-cap // page_size)
        n_pages = 1 + batch * npp                          # + the scratch page
        entry: Dict[str, Any] = {
            "pos": torch.full((p_dim, n_pages, page_size), INVALID_POS,
                              dtype=torch.int32, device=dev),
            "page_table": torch.zeros((p_dim, batch, npp), dtype=torch.int32, device=dev),
        }
        if oracle:
            shape = (p_dim, n_pages, page_size, hl.kvp, dh)
            entry["k"] = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
            entry["v"] = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        else:
            wshape = (p_dim, n_pages, page_size, hl.kvp, packed_width(dh))
            for name in ("k_plus", "k_minus", "v_plus", "v_minus"):
                entry[name] = torch.zeros(wshape, dtype=torch.int32, device=dev)
            for name in ("k_scale", "v_scale"):
                entry[name] = torch.zeros((p_dim, n_pages, page_size),
                                          dtype=torch.float32, device=dev)
        caches.append(entry)
    return caches


def paged_logical_axes(cfg: ModelConfig) -> List[Dict[str, Any]]:
    """Logical axis names per paged leaf (a superset of the packed and
    oracle keys); on one card nothing is sharded by them."""
    axes = {
        "pos": (None, None, None),
        "page_table": (None, "batch", None),
        "k": (None, None, None, "kv_heads", None),
        "v": (None, None, None, "kv_heads", None),
        "k_plus": (None, None, None, "kv_heads", None),
        "k_minus": (None, None, None, "kv_heads", None),
        "v_plus": (None, None, None, "kv_heads", None),
        "v_minus": (None, None, None, "kv_heads", None),
        "k_scale": (None, None, None),
        "v_scale": (None, None, None),
    }
    return [dict(axes) for _ in cfg.layer_pattern]


# ---------------------------------------------------------------------------
# Quantize at append
# ---------------------------------------------------------------------------

def ternarize_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token TWN over the trailing (heads, dh) axes: threshold ``0.7 *
    mean|x|``, scale ``alpha = E[|x| : |x| > thr]``.  Returns (t in
    {-1, 0, +1} float32, alpha (...,) float32)."""
    xf = x.to(torch.float32)
    absx = xf.abs()
    cnt = absx.shape[-2] * absx.shape[-1]
    thr = 0.7 * (absx.sum(dim=(-2, -1), keepdim=True) / cnt)
    mask = absx > thr
    t = torch.sign(xf) * mask
    denom = mask.sum(dim=(-2, -1)).clamp(min=1)
    alpha = torch.where(mask, absx, 0.0).sum(dim=(-2, -1)) / denom.to(torch.float32)
    return t, alpha


def append_tokens(entry: Dict[str, Any], k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, live: torch.Tensor) -> Dict[str, Any]:
    """Write S new tokens per slot into the entry's pages, in place.

    k/v (B,S,KVp,dh) roped projections; positions (B,S) absolute; live
    (B,S) bool, False for chunk padding and rows not writing this call
    (they go to the scratch page with ``INVALID_POS``).  The entry's
    leaves carry no period dim.  Returns the entry."""
    n_pages, page, npp = entry_geometry(entry)
    l_cap = npp * page
    pos32 = positions.to(torch.int32)
    # of two tokens of this call meeting in one ring slot, only the later
    # one lands (decode's one-token-per-step ring writes)
    last = torch.where(live, pos32, -1).amax(dim=1, keepdim=True)
    live = live & (pos32 + l_cap > last)
    slot = pos32 % l_cap
    lp, off = (slot // page).long(), (slot % page).long()
    pid = torch.gather(entry["page_table"], 1, lp)
    pid = torch.where(live, pid, SCRATCH_PAGE).long()
    src = _scratch_sources(live, off, page)

    def land(x):
        """``x`` (B, S, ...) as its writers carry it: a dead token the
        values of its scratch slot's last dead token."""
        return x.reshape(-1, *x.shape[2:])[src].reshape(x.shape)

    entry["pos"][pid, off] = torch.where(live, pos32, INVALID_POS)
    if "k_plus" in entry:
        for name, val in (("k", k), ("v", v)):
            t, alpha = ternarize_tokens(val)
            plus, minus = pack_ternary(t)
            entry[f"{name}_plus"][pid, off] = land(plus)
            entry[f"{name}_minus"][pid, off] = land(minus)
            entry[f"{name}_scale"][pid, off] = land(alpha)
    else:
        entry["k"][pid, off] = land(k.to(entry["k"].dtype))
        entry["v"][pid, off] = land(v.to(entry["v"].dtype))
    return entry


def _scratch_sources(live: torch.Tensor, off: torch.Tensor, page: int) -> torch.Tensor:
    """For each of the (B, S) tokens of a write, row-major, the token whose
    values it writes: itself when live; for a dead token, the last dead
    token (row-major) of its scratch-page slot.

    Dead tokens share the scratch page, several to a slot, and what a
    slot holds matters: a row with no live key attends to its whole view,
    scratch slots included, and its output enters the per-tensor
    activation statistics of the next projection, live rows and all.  A
    CUDA scatter lands an arbitrary one of several writers of an
    element; with every writer carrying the same values the result is
    the reference's (and the CPU's) sequential last-write-wins, run after
    run."""
    flat_live, flat_off = live.reshape(-1), off.reshape(-1)
    t = torch.arange(flat_live.numel(), device=live.device)
    last = torch.full((page,), -1, dtype=torch.long, device=live.device).scatter_reduce(
        0, flat_off, torch.where(flat_live, -1, t), reduce="amax")
    return torch.where(flat_live, t, last[flat_off])


def page_view(entry: Dict[str, Any], dh: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense per-slot gather view for attention reads -> (k, v, pos): k/v
    (B, L_cap, KVp, dh) float32 (packed) or bf16 (oracle), pos (B, L_cap)
    with ``L_cap = npp * page``.  Packed words decode as
    ``(unpack(plus) - unpack(minus)) * alpha``; unallocated pages resolve
    to the scratch page, whose positions fail every ``pos <= step``."""
    n_pages, page, npp = entry_geometry(entry)
    table = entry["page_table"].long()                    # (B, npp)
    b = table.shape[0]
    pos = entry["pos"][table].reshape(b, npp * page)
    if "k_plus" in entry:
        def dec(name):
            val = (unpack_bits(entry[f"{name}_plus"][table], dh)
                   - unpack_bits(entry[f"{name}_minus"][table], dh)).to(torch.float32)
            scale = entry[f"{name}_scale"][table]
            return (val * scale[..., None, None]).reshape(b, npp * page, val.shape[-2], dh)
        return dec("k"), dec("v"), pos
    kvp = entry["k"].shape[-2]
    return (entry["k"][table].reshape(b, npp * page, kvp, dh),
            entry["v"][table].reshape(b, npp * page, kvp, dh), pos)


# ---------------------------------------------------------------------------
# Host-side page bookkeeping
# ---------------------------------------------------------------------------

class PageAllocator:
    """Free-list allocator over the data pages ``1..n_pages-1``; raises on
    exhaustion and on double or foreign frees, so accounting can be held
    to zero after release."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))      # pop() -> low pids
        self._used: set = set()
        self.high_water = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._used)

    def alloc(self, n: int = 1) -> List[int]:
        if faults.fire("pages.exhausted", want=n):
            raise PagePoolExhausted(
                f"page pool exhausted (injected): want {n}, have "
                f"{len(self._free)} free of {self.n_pages - 1}")
        if n > len(self._free):
            raise PagePoolExhausted(
                f"page pool exhausted: want {n}, have {len(self._free)} "
                f"free of {self.n_pages - 1}")
        out = [self._free.pop() for _ in range(n)]
        self._used.update(out)
        self.high_water = max(self.high_water, len(self._used))
        return out

    def free(self, pids: Sequence[int]) -> None:
        for p in pids:
            if p not in self._used:
                raise RuntimeError(f"double/foreign free of page {p}")
            self._used.discard(p)
            self._free.append(p)


class EntryPager:
    """Host mirror of one paged entry: an allocator and per-slot page
    lists; the device ``page_table`` is rebuilt from :attr:`table` when
    :attr:`dirty` (:func:`sync_page_tables`)."""

    def __init__(self, num_slots: int, npp: int, page: int, n_pages: int):
        self.npp, self.page = npp, page
        self.alloc = PageAllocator(n_pages)
        self.table = np.zeros((num_slots, npp), np.int32)
        self.owned: List[List[int]] = [[] for _ in range(num_slots)]
        self.dirty = True

    @classmethod
    def from_entry(cls, entry: Dict[str, Any], num_slots: int) -> "EntryPager":
        n_pages, page, npp = entry_geometry(entry)
        return cls(num_slots, npp, page, n_pages)

    def ensure(self, slot: int, hi: int) -> None:
        """Back positions [0, hi) of ``slot`` (ring-capped at npp pages),
        pages handed out in logical order."""
        need = min(-(-hi // self.page), self.npp)
        while len(self.owned[slot]) < need:
            (pid,) = self.alloc.alloc(1)
            self.table[slot, len(self.owned[slot])] = pid
            self.owned[slot].append(pid)
            self.dirty = True

    def release(self, slot: int) -> List[int]:
        """Reclaim all of ``slot``'s pages; returns the freed pids (poison
        their positions with :func:`reset_pages`)."""
        pids, self.owned[slot] = self.owned[slot], []
        if pids:
            self.table[slot, :] = 0
            self.alloc.free(pids)
            self.dirty = True
        return pids

    def device_table(self, num_periods: int, device=DEFAULT_DEVICE) -> torch.Tensor:
        """(num_periods, B, npp) int32 on ``device``."""
        self.dirty = False
        t = torch.from_numpy(self.table.copy()).to(resolve_device(device))
        return t[None].expand((num_periods,) + t.shape).contiguous()

    def stats(self) -> Dict[str, int]:
        return {"total": self.alloc.n_pages - 1, "used": self.alloc.n_used,
                "free": self.alloc.n_free, "high_water": self.alloc.high_water}


def make_pagers(caches: Sequence[Any], num_slots: int) -> List[Optional[EntryPager]]:
    return [EntryPager.from_entry(e, num_slots) if is_paged(e) else None for e in caches]


def sync_page_tables(caches: Sequence[Any],
                     pagers: Sequence[Optional[EntryPager]]) -> List[Any]:
    """Copy dirty host tables into the caches' ``page_table`` leaves, in
    place; returns the caches (a new list)."""
    for e, pg in zip(caches, pagers):
        if pg is not None and pg.dirty:
            e["page_table"].copy_(pg.device_table(e["pos"].shape[0], e["pos"].device))
    return list(caches)


def reset_pages(entry: Dict[str, Any], pids: Sequence[int]) -> Dict[str, Any]:
    """Poison freed pages' positions (between steps), so a later owner
    never reads a stale in-window position before overwriting it."""
    if not len(pids):
        return entry
    idx = torch.tensor(list(pids), dtype=torch.long, device=entry["pos"].device)
    entry["pos"][:, idx] = INVALID_POS
    return entry


def tree_nbytes(tree: Any) -> int:
    """Total bytes of every tensor in a (nested dict / list) cache tree."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0
