"""Mixture-of-Experts FFN with sort-based capacity dispatch.

Counterpart of ``repro/models/moe.py``:

* float32 router, top-k with renormalisation;
* per-example dispatch by a stable argsort of the chosen experts, so a
  full expert drops tokens by position (GShard/Switch); capacity
  ``cap = min(max(k, ceil(S * k * cf / E)), S * k)`` per example;
* the expert products run one expert at a time: each expert's
  ``(B * cap, k)`` rows go through ``packed_matmul_any`` (packed
  weights) or ``quantized_matmul`` (master weights) on their own, so each
  expert quantizes its activations with its own statistics, as the
  reference's ``vmap`` over the expert axis does;
* the combine and the Switch load-balancing aux loss; an optional
  shared expert (a dense gated FFN) added to every token.  On a split
  batch (the training mesh, ``sharding.split_batch``) the aux loss takes
  the global batch's token and probability fractions: the expert counts
  and probability sums are summed over the batch axes before the product.

On a tensor-parallel split of "ffn" (the training mesh under
``TRAIN_RULES`` or ``TRAIN_RULES_HYBRID``) each rank holds its ffn chunk
of every expert and of the shared expert.  Capacity drops go by position
within an example, so the layer works on the whole sequence: the router
runs on this rank's sequence shard and its probabilities are gathered
(``sharding.seq_gather``: routing, dispatch, combine and aux loss are the
same on every rank, and the router's gradient sums over the axis as its
plan says), the tokens are gathered once (``sharding.tp_enter``) for the
dispatch and the shared expert, gate and up run column-parallel on the
rank's ffn slice with each expert's activation statistics (under INT8 /
INT4 also each weight's grid over its whole ffn, every expert's in one
collective), and down runs
row-parallel: every expert's and the shared expert's int32 partial
counts, and their statistics, are reduced over the axis together
(``ops.row_parallel_group``: one collective for the counts, one per
statistics round) before each one's eq. (2) epilogue.  The combine is
then the whole sequence's on every rank, and ``sharding.constrain``
keeps this rank's shard.

The published Qwen1.5-MoE block turns three switches of the config
(single device; on a tensor-parallel split dropless routing raises):

* ``moe_renormalize`` False: the experts are weighed by the router's own
  top-k probabilities;
* ``moe_dropless``: no capacity.  The B*S*k choices are sorted by expert
  (stable) and the per-expert counts read to the host once a layer (the
  shared expert queued while they travel), for the largest: the rows
  are laid out (E, that count, D), each expert's
  routed rows first and zeros after them.  Each expert's products are a
  ``qmm`` of exactly its routed rows (``ops.qmm_grouped``: its
  activation statistics cover those rows only, the zeros add nothing to
  them and come out zero), every expert's in one quantization a
  projection input and one kernel launch a projection; the combine
  reads each token's k outputs back in increasing expert id and sums
  them in float32;
* ``shared_expert_gate``: the shared expert's output times
  ``sigmoid(x . w_gate)`` (float32; ``w_gate`` the (d, 1) float leaf
  "shared_gate", never quantized).

Spans (``repro_torch.obs``): ``repro_torch.moe.route`` (router product,
softmax, top-k), ``repro_torch.moe.dispatch`` (sort, counts, row
gather), ``repro_torch.moe.experts`` (every expert's products and their
glue, the shared expert's too) and ``repro_torch.moe.combine`` (weighted
sum, shared gate, aux loss).  Dropless, a layer enters dispatch and
experts twice each: sort and counts, the shared expert, the counts'
arrival and the row gather, the routed experts.

Determinism: a dispatch slot receives at most one kept token, so the
dispatch is an index assignment (dropped tokens go to a scratch slot
that is cut off).  The combine sums up to ``k`` contributions per token:
they are gathered into ``(B, S, k, D)`` and added in a fixed order (by
expert id, the order in which the reference's scatter meets them), never
by a float scatter-add whose order on the card changes from run to run.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.modes import DEFAULT_DEVICE, QuantMode, resolve_device
from repro_torch.kernels.qtensor import QTensor
from repro_torch.models.common import ModelConfig, einsum_f32
from repro_torch.models.ffn import ffn, init_ffn
from repro_torch.models.packing import packed_matmul_any
from repro_torch.parallel import sharding

__all__ = ["init_moe", "moe_ffn", "moe_capacity"]


def init_moe(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """Router (d, E) float32, expert gate/up (E, d, f) and down (E, f, d),
    the shared expert when the config has one, and its gate (d, 1)
    float32 under ``shared_expert_gate`` (drawn last)."""
    dev = resolve_device(device)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def normal(shape, std, dt):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dt)

    p = {"router": normal((d, e), d ** -0.5, torch.float32),
         "gate": {"w": normal((e, d, f), d ** -0.5, dtype)},
         "up": {"w": normal((e, d, f), d ** -0.5, dtype)},
         "down": {"w": normal((e, f, d), f ** -0.5, dtype)}}
    if cfg.shared_expert_d_ff:
        p["shared"] = init_ffn(generator, d, cfg.shared_expert_d_ff, dtype, dev)
        if cfg.shared_expert_gate:
            p["shared_gate"] = normal((d, 1), d ** -0.5, torch.float32)
    return p


def moe_capacity(cfg: ModelConfig, s: int) -> int:
    """Slots per expert and example for a sequence of ``s`` tokens."""
    k = cfg.num_experts_per_tok
    cap = max(k, int(-(-s * k * cfg.capacity_factor // cfg.num_experts)))
    return min(cap, s * k)


def _expert_rows(w, i: int, x2: torch.Tensor, mode: QuantMode, backend: str) -> torch.Tensor:
    """x2 (m, k) @ expert ``i`` of w (E, k, n) -> (m, n) float32 (on float
    modes in ``x2``'s dtype); ``w`` an expert-stacked QTensor or a
    ``{"w": ...}`` leaf.  A quantized product takes its activation
    statistics from these rows."""
    if isinstance(w, QTensor):
        return packed_matmul_any(w.period(i), x2, backend)
    w = w["w"] if isinstance(w, dict) else w
    if mode.is_float:
        ct = torch.bfloat16 if mode == QuantMode.BF16 else torch.float32
        return einsum_f32("mk,kn->mn", x2.to(ct), w[i].to(ct)).to(x2.dtype)
    return ops.quantized_matmul(x2.to(torch.float32), w[i].to(torch.float32), mode, backend)


def _expert_matmul(w, h: torch.Tensor, mode: QuantMode, backend: str) -> torch.Tensor:
    """h (E, C', k) @ w (E, k, n) -> (E, C', n) in h's dtype, one expert
    at a time; ``w`` an expert-stacked QTensor or a ``{"w": ...}`` leaf."""
    if mode.is_float and not isinstance(w, QTensor):
        w = w["w"] if isinstance(w, dict) else w
        ct = torch.bfloat16 if mode == QuantMode.BF16 else torch.float32
        return einsum_f32("eck,ekn->ecn", h.to(ct), w.to(ct)).to(h.dtype)
    ys = [_expert_rows(w, i, h[i], mode, backend) for i in range(h.shape[0])]
    return torch.stack(ys).to(h.dtype)


def _expert_proj(w, xp: torch.Tensor, counts: torch.Tensor, sizes, mode: QuantMode,
                 backend: str, *more) -> list:
    """xp (E, C, k): expert i's rows ``xp[i, :sizes[i]]`` (``counts`` on the
    device, ``sizes`` on the host), zeros after them, against expert i of
    ``w`` and of each leaf of ``more`` (expert-stacked QTensors or
    ``{"w": ...}`` leaves) -> (E, C, n) float32 (on float modes in
    ``xp``'s dtype) a leaf, zero past each expert's rows.  A quantized
    product takes its activation statistics from its expert's rows."""
    ws = (w,) + more
    if all(isinstance(v, QTensor) for v in ws):
        return ops.qmm_grouped(xp, ws, counts, sizes, backend=backend)
    outs = []
    for v in ws:
        v = v["w"] if isinstance(v, dict) else v
        if mode.is_float:
            ct = torch.bfloat16 if mode == QuantMode.BF16 else torch.float32
            outs.append(einsum_f32("eck,ekn->ecn", xp.to(ct), v.to(ct)).to(xp.dtype))
            continue
        out = xp.new_zeros(xp.shape[:2] + (v.shape[-1],), dtype=torch.float32)
        for i, c in enumerate(sizes):
            if c:
                out[i, :c] = ops.quantized_matmul(xp[i, :c].to(torch.float32),
                                                  v[i].to(torch.float32), mode, backend)
        outs.append(out)
    return outs


def _swiglu_experts(params: Dict[str, Any], xp: torch.Tensor, counts: torch.Tensor, sizes,
                    mode: QuantMode, backend: str) -> torch.Tensor:
    """Every expert on its rows, xp (E, C, D) as :func:`_expert_proj`
    takes them -> (E, C, D) in xp's dtype, zero past each expert's rows:
    gate and up (one quantization of their shared input), SiLU(gate) * up
    in float32, down; each product rounded to the stream's type, as every
    projection's output is."""
    dt = xp.dtype
    g, u = _expert_proj(params["gate"], xp, counts, sizes, mode, backend, params["up"])
    h = (F.silu(g.to(dt).to(torch.float32)) * u.to(dt).to(torch.float32)).to(dt)
    return _expert_proj(params["down"], h, counts, sizes, mode, backend)[0].to(dt)


def _experts_tp(params: Dict[str, Any], h_in: torch.Tensor, xw: torch.Tensor,
                cfg: ModelConfig, policy: QuantPolicy, dt: torch.dtype):
    """The expert products on a tensor-parallel split of "ffn": ``h_in``
    (E, C', D) the dispatched rows and ``xw`` (B, S, D) the whole sequence
    (float32 holding ``dt`` values, ``sharding.tp_enter``).  -> (y_e (E,
    C', D), the shared expert's (B, S, D) or None), in ``dt``, whole on
    every rank (module docstring)."""
    e = h_in.shape[0]
    mode, backend = policy.ffn_proj, policy.backend_for("ffn_proj")
    shared = params["shared"] if cfg.shared_expert_d_ff else None
    xs = list(h_in.unbind(0))
    leaves = {k: list(params[k]["w"].unbind(0)) for k in ("gate", "up", "down")}
    if shared is not None:
        xs.append(xw.reshape(-1, xw.shape[-1]))
        for k in leaves:
            leaves[k].append(shared[k]["w"])
    split = sharding.tp_split("ffn")
    n = len(xs)
    act, wst = [None] * n, [None] * (2 * n)
    if not mode.is_float and split.axes:
        # gate and up share their input: one set of statistics, one
        # collective per round for every expert
        act = ops.split_batch_stats_many(xs, mode, split)
    if mode in (QuantMode.INT8, QuantMode.INT4):
        # every gate's and up's grid over its whole ffn in one collective
        wst = ops.split_weight_stats_many(leaves["gate"] + leaves["up"], mode, split)

    def col(x, w, a, ws):
        return ops.quantized_matmul(x, w.to(torch.float32), mode, backend, role="col",
                                    stats={"act": a, "w": ws}).to(dt)

    hs = [(F.silu(col(x, g, a, wst[i]).to(torch.float32))
           * col(x, u, a, wst[n + i]).to(torch.float32)).to(dt)
          for i, (x, g, u, a) in enumerate(zip(xs, leaves["gate"], leaves["up"], act))]
    ys = ops.row_parallel_group(hs, leaves["down"], mode, backend)
    y_e = torch.stack(ys[:e]).to(dt)
    y_sh = ys[e].reshape(xw.shape[:-1] + (-1,)).to(dt) if shared is not None else None
    return y_e, y_sh


def _route(params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig):
    """(probs (B, S, E) float32 over the whole sequence, top_p, top_i
    (B, S, k)): top-k as a stable descending sort, so equal probabilities
    keep the lower expert first on any device (lax.top_k's order);
    ``top_p`` renormalised to sum to 1 under ``cfg.moe_renormalize``."""
    k = cfg.num_experts_per_tok
    with obs.annotate("repro_torch.moe.route"):
        logits = einsum_f32("bsd,de->bse", x, params["router"])
        probs = sharding.seq_gather(torch.softmax(logits, dim=-1))
        top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_i = top_p[..., :k], top_i[..., :k]
        if cfg.moe_renormalize:
            top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return probs, top_p, top_i


def _in_order(contrib: torch.Tensor, order: torch.Tensor, k: int) -> torch.Tensor:
    """contrib (B, SK, D), entry j of row b the choice ``order[b, j]``
    (token ``order // k``), sorted by expert -> (B, S, k, D): each token's
    k entries in increasing expert id, the order in which the reference's
    scatter meets them (a token's k choices are distinct experts)."""
    b, sk = order.shape
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(sk, device=order.device).expand(b, sk))
    slots = torch.sort(rank.reshape(b, sk // k, k), dim=-1).values
    rows = torch.arange(b, device=order.device)[:, None, None]
    return contrib[rows, slots]


def _aux_loss(probs: torch.Tensor, expert_counts: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """The Switch load-balancing loss (eq. 4) from the router's
    probabilities and each expert's count of choices (E,).  On a split
    batch (the training mesh) the global batch's fractions, from the
    counts and the probability sums of every rank's rows (not linear in
    the rows)."""
    e = cfg.num_experts
    b, s = probs.shape[0], probs.shape[1]
    sk = s * cfg.num_experts_per_tok
    split = sharding.batch_split()
    if split is None or not split.axes:
        frac_tokens = expert_counts.to(torch.float32) / (b * sk)     # mean of the one-hots
        frac_probs = probs.mean(dim=(0, 1))
    else:
        n = split.reduce(torch.tensor([b * sk, b * s], dtype=torch.int64, device=probs.device))
        frac_tokens = split.reduce(expert_counts).to(torch.float32) / n[0].to(torch.float32)
        frac_probs = sharding.sum_over_batch(probs.sum(dim=(0, 1))) / n[1].to(torch.float32)
    return e * (frac_tokens * frac_probs).sum() * cfg.router_aux_loss


def _shared_gated(params: Dict[str, Any], x: torch.Tensor, y_sh: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """The shared expert's output ``y_sh`` times sigmoid(x . w_gate) in
    float32 under ``cfg.shared_expert_gate``, else as it is."""
    if not cfg.shared_expert_gate:
        return y_sh
    gate = torch.sigmoid(einsum_f32("bsd,do->bso", x, params["shared_gate"]))
    return y_sh.to(torch.float32) * gate


def _host_read(t: torch.Tensor) -> Callable[[], list]:
    """Start reading the small integer tensor ``t`` to the host; -> a
    function that waits for the values and returns them as a list.  On
    CUDA the copy lands in pinned memory behind an event, so the wait ends
    when the copy has, not when the card's queue has drained: work queued
    between the two calls keeps the card busy meanwhile."""
    if not t.is_cuda:
        return t.tolist
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    landed = torch.cuda.Event()
    landed.record()

    def wait() -> list:
        landed.synchronize()
        return host.tolist()
    return wait


def _moe_dropless(params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                  policy: QuantPolicy) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` without capacity (module docstring), on one device."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    b, s, d = x.shape
    n = b * s * k
    probs, top_p, top_i = _route(params, x, cfg)

    with obs.annotate("repro_torch.moe.dispatch"):
        se, order = torch.sort(top_i.reshape(n), stable=True)
        bounds = torch.searchsorted(se, torch.arange(e + 1, device=x.device))
        counts = bounds[1:] - bounds[:-1]
        read_counts = _host_read(counts)                           # one host read a layer

    with obs.annotate("repro_torch.moe.experts"):
        # queued while the counts travel, so the card is busy when they land
        y_sh = ffn(params["shared"], x, policy) if cfg.shared_expert_d_ff else None

    with obs.annotate("repro_torch.moe.dispatch"):
        sizes = read_counts()
        c = max(sizes)
        # choice j (sorted) -> its row of the (E * C, D) layout
        slot = se * c + torch.arange(n, device=x.device) - bounds[se]
        xp = x.new_zeros((e * c, d))
        xp[slot] = x.reshape(b * s, d)[order // k]

    with obs.annotate("repro_torch.moe.experts"):
        mode, backend = policy.ffn_proj, policy.backend_for("ffn_proj")
        yp = _swiglu_experts(params, xp.reshape(e, c, d), counts, sizes, mode, backend)
        y_rows = yp.reshape(e * c, d)[slot]                        # (N, D) by expert

    with obs.annotate("repro_torch.moe.combine"):
        w_sorted = top_p.reshape(n)[order]
        contrib = y_rows.to(torch.float32) * w_sorted[:, None]      # (N, D) float32
        per_tok = _in_order(contrib[None], order[None], k)[0]       # (B*S, k, D)
        y = per_tok[:, 0]
        for j in range(1, k):
            y = y + per_tok[:, j]
        y = y.reshape(b, s, d)
        if y_sh is not None:
            y = y + _shared_gated(params, x, y_sh, cfg)
        aux = _aux_loss(probs, counts, cfg)
    return y.to(x.dtype), aux


def moe_ffn(params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
            policy: QuantPolicy) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux loss float32 scalar).  On a
    sequence-parallel split x and y are this rank's sequence shard."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    dev = x.device
    tp = sharding.tp_split("ffn")
    if cfg.moe_dropless:
        if tp is not None:
            raise NotImplementedError("dropless routing (moe_dropless) is single-device: "
                                      "no tensor-parallel split of 'ffn'")
        return _moe_dropless(params, x, cfg, policy)

    probs, top_p, top_i = _route(params, x, cfg)
    # the whole sequence: the rows the dispatch reads (float32 holding x's
    # values on a tensor-parallel split)
    xw = sharding.tp_enter(x) if tp is not None else x
    b, s, d = xw.shape
    sk = s * k
    cap = moe_capacity(cfg, s)

    # ---- dispatch (stable sort: position-priority drops) ----
    with obs.annotate("repro_torch.moe.dispatch"):
        e_flat = top_i.reshape(b, sk)
        se, order = torch.sort(e_flat, dim=-1, stable=True)
        counts = torch.zeros((b, e), dtype=torch.int64, device=dev).scatter_add_(
            1, e_flat, torch.ones_like(e_flat))                      # (B, E), integers
        starts = counts.cumsum(dim=-1) - counts
        pos = torch.arange(sk, device=dev)[None, :] - torch.gather(starts, 1, se)
        keep = pos < cap
        dest = se * cap + pos.clamp(0, cap - 1)                      # (B, SK)
        tok = order // k
        rows = torch.arange(b, device=dev)[:, None]
        buf = torch.zeros((b, e * cap + 1, d), dtype=xw.dtype, device=dev)
        buf[rows, torch.where(keep, dest, e * cap)] = xw[rows, tok]  # slot e*cap: scratch
        buf = buf[:, :e * cap]

    # ---- expert products ----
    with obs.annotate("repro_torch.moe.experts"):
        h_in = buf.reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)
        y_sh = None
        if tp is not None:
            y_e, y_sh = _experts_tp(params, h_in, xw, cfg, policy, x.dtype)
        else:
            mode, backend = policy.ffn_proj, policy.backend_for("ffn_proj")
            g = _expert_matmul(params["gate"], h_in, mode, backend)
            u = _expert_matmul(params["up"], h_in, mode, backend)
            h = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
            y_e = _expert_matmul(params["down"], h, mode, backend)    # (E, B*cap, D)
            if cfg.shared_expert_d_ff:
                y_sh = ffn(params["shared"], x, policy)
        y_buf = y_e.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)

    # ---- combine, in a fixed order ----
    with obs.annotate("repro_torch.moe.combine"):
        w_sorted = torch.gather(top_p.reshape(b, sk), 1, order)
        contrib = (y_buf[rows, dest] * keep[..., None].to(y_buf.dtype)
                   * w_sorted[..., None].to(y_buf.dtype))             # (B, SK, D)
        per_tok = _in_order(contrib, order, k)                        # (B, S, k, D)
        y = torch.zeros((b, s, d), dtype=y_buf.dtype, device=dev)
        for j in range(k):
            y = y + per_tok[:, :, j]
        if y_sh is not None:
            y = y + _shared_gated(params, xw if tp is not None else x, y_sh, cfg)
        if tp is not None:
            y = sharding.constrain(y, ("batch", "seq", "embed"))
        aux = _aux_loss(probs, counts.sum(dim=0), cfg)
    return y, aux
