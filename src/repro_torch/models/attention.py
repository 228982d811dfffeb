"""Attention: GQA / sliding-window / softcap, prefill + decode paths.

Counterpart of ``repro/models/attention.py``.  Projections route through
the low-bit GeMM pipeline via the layer's :class:`QuantPolicy` (the
paper's technique applied to QKV/O): :func:`project` runs one ``qmm`` on
an offline-packed QTensor, or ``quantized_matmul`` on float master
weights.  Score and mix products are plain float32 products (TF32 off),
as the reference's XLA einsums, with the reference's ``-1e30`` masking.

Head layout under tensor parallelism: KV heads are replicated into
``KVp = ceil_to(KV, tp)`` slots and Q heads laid out in groups of ``G``
per KV slot, surplus slots being zero padding heads (output-exact); with
tp=1 (one card) the layout is the identity.

KV caches are written in place: ``attention(..., cache_update=c)`` fills
``c`` with the prompt's roped K/V, :func:`decode_attention` writes one
token per row at ``step`` (``step % L`` in a ring cache of a windowed
layer), :func:`paged_attention_step` writes a decode token or a prefill
chunk into the pages of a paged entry (models/paged_kvcache.py), and
each returns the cache it wrote.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qlinear import linear_apply
from repro_torch.core.quantize import f32_scalar
from repro_torch.kernels.modes import DEFAULT_DEVICE, QuantMode, resolve_device
from repro_torch.kernels.qtensor import QTensor
from repro_torch.models.common import (ModelConfig, ShardLayout, apply_rope, ceil_to,
                                       einsum_f32, rms_norm, softcap)
from repro_torch.models.packing import packed_matmul_any
from repro_torch.parallel import sharding

__all__ = ["HeadLayout", "head_layout", "init_attention", "attention",
           "decode_attention", "paged_attention_step", "project", "to_cache",
           "KV_SCALE"]


# ---------------------------------------------------------------------------
# Head layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeadLayout:
    h: int          # logical Q heads
    kv: int         # logical KV heads
    hp: int         # physical Q heads (kvp * g)
    kvp: int        # physical KV slots
    g: int          # Q heads per KV slot
    q_src: Tuple[int, ...]    # physical q slot -> logical q head or -1 (pad)
    kv_src: Tuple[int, ...]   # physical kv slot -> logical kv head


def head_layout(h: int, kv: int, tp: int) -> HeadLayout:
    assert h % kv == 0, f"H={h} must be a multiple of KV={kv}"
    kvp = ceil_to(kv, tp) if tp > 1 else kv
    assert kvp % kv == 0, (
        f"KV={kv} does not divide its padded count {kvp} (tp={tp}); "
        f"choose tp so that ceil_to(kv, tp) is a kv multiple")
    copies = kvp // kv
    qpk = h // kv
    g = -(-qpk // copies)
    hp = kvp * g
    kv_src = tuple(s // copies for s in range(kvp))
    q_src = []
    for s in range(kvp):
        j, t = s // copies, s % copies
        for p in range(g):
            q = t * g + p
            q_src.append(j * qpk + q if q < qpk else -1)
    return HeadLayout(h=h, kv=kv, hp=hp, kvp=kvp, g=g,
                      q_src=tuple(q_src), kv_src=tuple(kv_src))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_attention(generator: torch.Generator, cfg: ModelConfig, layout: ShardLayout,
                   dtype=torch.float32, device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """Physical (padded) attention weights on ``device``, drawn from
    ``generator``: random weights in real head slots, zero padding slots,
    identical KV copies — output-exact vs the logical model."""
    dev = resolve_device(device)
    d, dh = cfg.d_model, cfg.head_dim_
    hl = head_layout(cfg.num_heads, cfg.num_kv_heads, layout.tp)
    std = d ** -0.5

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev) * std

    wq_log = normal((d, hl.h, dh))
    wk_log = normal((d, hl.kv, dh))
    wv_log = normal((d, hl.kv, dh))
    wo_log = normal((hl.h, dh, d))

    q_src = torch.tensor([max(s, 0) for s in hl.q_src], device=dev)
    q_real = torch.tensor([s >= 0 for s in hl.q_src], dtype=torch.float32, device=dev)
    kv_src = torch.tensor(hl.kv_src, device=dev)

    wq = (wq_log[:, q_src, :] * q_real[None, :, None]).reshape(d, hl.hp * dh)
    wk = wk_log[:, kv_src, :].reshape(d, hl.kvp * dh)
    wv = wv_log[:, kv_src, :].reshape(d, hl.kvp * dh)
    wo = (wo_log[q_src, :, :] * q_real[:, None, None]).reshape(hl.hp * dh, d)

    p = {"wq": {"w": wq.to(dtype)}, "wk": {"w": wk.to(dtype)},
         "wv": {"w": wv.to(dtype)}, "wo": {"w": wo.to(dtype)}}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((dh,), dtype=dtype, device=dev)
    return p


def project(params: Dict[str, Any] | QTensor, x: torch.Tensor,
            mode: QuantMode, backend: str) -> torch.Tensor:
    """QuantLinear forward on a ``{"w": ...}`` leaf (``linear_apply``: the
    QAT path), or on a packed :class:`QTensor` leaf (offline-packed
    weights, see models/packing.py) — told apart by type; a packed leaf
    carries its own mode, depth and scale."""
    if isinstance(params, QTensor):
        y = packed_matmul_any(params, x.reshape(-1, x.shape[-1]), backend)
        return y.reshape(*x.shape[:-1], params.out_features).to(x.dtype)
    return linear_apply(params, x, mode, backend)


# ---------------------------------------------------------------------------
# Forward (training / prefill): block-causal attention
# ---------------------------------------------------------------------------

def _qkv(params, x, cfg: ModelConfig, hl: HeadLayout, positions,
         policy: QuantPolicy):
    b, s, _ = x.shape
    dh = cfg.head_dim_
    mode, backend = policy.attn_proj, policy.backend_for("attn_proj")
    if s > 1:
        x = sharding.constrain(x, ("batch", "seq", None))
    q = project(params["wq"], x, mode, backend).reshape(b, s, hl.hp, dh)
    k = project(params["wk"], x, mode, backend).reshape(b, s, hl.kvp, dh)
    v = project(params["wv"], x, mode, backend).reshape(b, s, hl.kvp, dh)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = sharding.constrain(q, ("batch", None, "heads", None))
    k = sharding.constrain(k, ("batch", None, "kv_heads", None))
    v = sharding.constrain(v, ("batch", None, "kv_heads", None))
    return q, k, v


def _block_attend(q_blk, k_ctx, v_ctx, pos_q, pos_k, *, g: int,
                  window: int, cap: float, dh: int):
    """q_blk (B,Sq,HP,dh) vs k/v (B,Sk,KVP,dh) -> (B,Sq,HP,dh) float32;
    causal (+ window) mask from positions."""
    b, sq, hp, _ = q_blk.shape
    kvp = k_ctx.shape[2]
    qg = q_blk.reshape(b, sq, kvp, g, dh)
    scores = einsum_f32("bqkgd,bskd->bkgqs", qg, k_ctx) * (dh ** -0.5)
    scores = softcap(scores, cap)
    mask = pos_q[:, None] >= pos_k[None, :]
    if window:
        mask &= (pos_q[:, None] - pos_k[None, :]) < window
    scores = torch.where(mask[None, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = einsum_f32("bkgqs,bskd->bqkgd", probs, v_ctx)
    return out.reshape(b, sq, hp, dh)


def attention(params, x, positions, cfg: ModelConfig, layout: ShardLayout,
              *, window: int = 0, q_chunk: int = 512,
              cache_update=None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Causal self-attention over x (B,S,D), positions (S,).

    Queries run in blocks of ``q_chunk``; each block attends only to its
    causal (and windowed) KV prefix.  With ``cache_update`` (a cache dict
    of one layer), the roped K/V are written into it (the last L of them
    when the prompt is longer than a ring cache) and it is returned
    beside the output."""
    b, s, d = x.shape
    dh = cfg.head_dim_
    hl = head_layout(cfg.num_heads, cfg.num_kv_heads, layout.tp)
    policy = cfg.policy
    q, k, v = _qkv(params, x, cfg, hl, positions, policy)

    qc = min(q_chunk, s)
    outs = []
    for q0 in range(0, s, qc):
        q1 = min(s, q0 + qc)
        kv_lo = max(0, (q0 - window) // qc * qc) if window else 0
        outs.append(_block_attend(q[:, q0:q1], k[:, kv_lo:q1], v[:, kv_lo:q1],
                                  positions[q0:q1], positions[kv_lo:q1],
                                  g=hl.g, window=window,
                                  cap=cfg.attn_logit_softcap, dh=dh))
    out = torch.cat(outs, dim=1).to(x.dtype)
    y = project(params["wo"], out.reshape(b, s, hl.hp * dh),
                policy.attn_proj, policy.backend_for("attn_proj"))

    if cache_update is None:
        return y, None
    ck, cv, cpos = cache_update["k"], cache_update["v"], cache_update["pos"]
    lim = ck.shape[1]
    if s >= lim:    # ring/window cache smaller than the prompt
        ck.copy_(to_cache(k[:, s - lim:], ck.dtype))
        cv.copy_(to_cache(v[:, s - lim:], cv.dtype))
        cpos.copy_(positions[s - lim:].expand(b, lim))
    else:
        ck[:, :s] = to_cache(k, ck.dtype)
        cv[:, :s] = to_cache(v, cv.dtype)
        cpos[:, :s] = positions.expand(b, s)
    return y, cache_update


# ---------------------------------------------------------------------------
# int8 KV cache: a static scale (post-norm K/V are O(1)), scores and mix
# as int8 x int8 products accumulated exactly (int32 in the reference).
# ---------------------------------------------------------------------------

KV_SCALE = 0.05
_F32_EXACT = 2 ** 24     # every integer of magnitude <= 2**24 is a float32


def to_cache(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.int8:
        x = x.to(torch.float32)
        return torch.clamp(torch.round(x / f32_scalar(KV_SCALE, x)),
                           -127, 127).to(torch.int8)
    return x.to(dtype)


def _int8_product(eq: str, a: torch.Tensor, b: torch.Tensor,
                  depth: int) -> torch.Tensor:
    """Exact int32 result of an int8 x int8 einsum reducing over
    ``depth`` elements: float32 while every partial sum stays below
    2**24 (127 * 127 * depth), float64 past that (CUDA has no int8
    einsum)."""
    dt = torch.float32 if 127 * 127 * depth <= _F32_EXACT else torch.float64
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.einsum(eq, a.to(dt), b.to(dt)).to(torch.int32)


def _int8_scores(qg, nk):
    qf = qg.to(torch.float32)
    q8 = torch.clamp(torch.round(qf / f32_scalar(KV_SCALE, qf)), -127, 127).to(torch.int8)
    acc = _int8_product("bkgd,blkd->bkgl", q8, nk, qg.shape[-1])
    return acc.to(torch.float32) * (KV_SCALE * KV_SCALE)


def _int8_mix(probs, nv):
    p8 = torch.round(probs * 127.0).to(torch.int8)
    acc = _int8_product("bkgl,blkd->bkgd", p8, nv, nv.shape[1])
    return acc.to(torch.float32) * (KV_SCALE / 127.0)


# ---------------------------------------------------------------------------
# Decode: one new token against a (possibly ring) KV cache
# ---------------------------------------------------------------------------

def decode_attention(params, x, cfg: ModelConfig, layout: ShardLayout,
                     cache: Dict[str, torch.Tensor], step,
                     *, window: int = 0) -> Tuple[torch.Tensor, Dict]:
    """x (B,1,D); cache {k,v: (B,L,KVP,dh), pos: (B,L) int32}; ``step`` a
    Python int, a scalar tensor or a per-slot (B,) vector (slots decode
    at different positions).

    For full caches L == max_seq; for windowed layers L == window and the
    slot is ``step % L`` (ring buffer).  Row b's K/V go to its own slot,
    in place.  Returns (y (B,1,D), the cache)."""
    b, s1, d = x.shape
    assert s1 == 1
    dh = cfg.head_dim_
    hl = head_layout(cfg.num_heads, cfg.num_kv_heads, layout.tp)
    policy = cfg.policy
    if isinstance(step, torch.Tensor):
        step_v = step.to(device=x.device, dtype=torch.int32).expand(b)
    else:
        step_v = torch.full((b,), int(step), dtype=torch.int32, device=x.device)
    positions = step_v[:, None]                       # (B, 1)
    q, k, v = _qkv(params, x, cfg, hl, positions, policy)

    nk, nv, npos = cache["k"], cache["v"], cache["pos"]
    l = nk.shape[1]
    slot = torch.where(step_v < l, step_v, step_v % l).long()
    rows = torch.arange(b, device=x.device)
    nk[rows, slot] = to_cache(k[:, 0], nk.dtype)
    nv[rows, slot] = to_cache(v[:, 0], nv.dtype)
    npos[rows, slot] = step_v

    qg = q.reshape(b, hl.kvp, hl.g, dh)
    # the query meets the cache at the cache's stored width, products
    # and sums in float32 (or exact integers for int8)
    if nk.dtype == torch.int8:
        scores = _int8_scores(qg, nk) * (dh ** -0.5)
    else:
        scores = einsum_f32("bkgd,blkd->bkgl", qg.to(nk.dtype), nk) * (dh ** -0.5)
    scores = softcap(scores, cfg.attn_logit_softcap)
    valid = npos <= step_v[:, None]
    if window:
        valid &= (step_v[:, None] - npos) < window
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    if nv.dtype == torch.int8:
        out = _int8_mix(probs, nv)
    else:
        out = einsum_f32("bkgl,blkd->bkgd", probs.to(nv.dtype), nv)
    out = out.reshape(b, 1, hl.hp * dh).to(x.dtype)
    y = project(params["wo"], out, policy.attn_proj, policy.backend_for("attn_proj"))
    return y, cache


def paged_attention_step(params, x, cfg: ModelConfig, layout: ShardLayout,
                         entry: Dict[str, torch.Tensor], step,
                         *, window: int = 0) -> Tuple[torch.Tensor, Dict]:
    """Write-then-attend over a paged cache entry (models/paged_kvcache).

    x (B,S,D): S new tokens per slot (S=1 decode, S=prefill_chunk for a
    chunked prefill).  ``step`` says what each row does:

    * (B,) int32 (or a scalar, or an int): decode, row b writes ONE token
      at position step[b]; step[b] < 0 marks a dead row that writes
      nothing and whose output is discarded;
    * (B, 2) int32: a chunk, row b writes ``step[b, 1]`` real tokens at
      positions ``step[b, 0] ..``; rows with step[b, 1] == 0 are dead.

    Dead and padding tokens go to the scratch page with ``INVALID_POS``.
    Scores and mix are float32 products of the page view.  Returns
    (y (B,S,D), the entry, written in place)."""
    from repro_torch.models import paged_kvcache as paged

    b, s, d = x.shape
    dh = cfg.head_dim_
    hl = head_layout(cfg.num_heads, cfg.num_kv_heads, layout.tp)
    policy = cfg.policy
    if not isinstance(step, torch.Tensor):
        step = torch.full((b,), int(step), dtype=torch.int32, device=x.device)
    step = step.to(device=x.device, dtype=torch.int32)
    if step.ndim == 2:
        p0, nvalid = step[:, 0], step[:, 1]
    else:
        step_v = step.expand(b)
        p0 = step_v.clamp(min=0)
        nvalid = (step_v >= 0).to(torch.int32)
    offs = torch.arange(s, dtype=torch.int32, device=x.device)
    positions = p0[:, None] + offs[None, :]                   # (B, S)
    live = offs[None, :] < nvalid[:, None]
    q, k, v = _qkv(params, x, cfg, hl, torch.where(live, positions, 0), policy)
    entry = paged.append_tokens(entry, k, v, positions, live)
    kd, vd, pos_k = paged.page_view(entry, dh)                # (B,L,KVp,dh)

    qg = q.reshape(b, s, hl.kvp, hl.g, dh)
    scores = einsum_f32("bskgd,blkd->bkgsl", qg, kd) * (dh ** -0.5)
    scores = softcap(scores, cfg.attn_logit_softcap)
    valid = pos_k[:, None, :] <= positions[:, :, None]        # (B, S, L)
    if window:
        valid &= (positions[:, :, None] - pos_k[:, None, :]) < window
    scores = torch.where(valid[:, None, None, :, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = einsum_f32("bkgsl,blkd->bskgd", probs, vd)
    out = out.reshape(b, s, hl.hp * dh).to(x.dtype)
    y = project(params["wo"], out, policy.attn_proj, policy.backend_for("attn_proj"))
    return y, entry
