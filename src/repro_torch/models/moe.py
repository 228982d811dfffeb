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

Determinism: a dispatch slot receives at most one kept token, so the
dispatch is an index assignment (dropped tokens go to a scratch slot
that is cut off).  The combine sums up to ``k`` contributions per token:
they are gathered into ``(B, S, k, D)`` and added in a fixed order (by
expert id, the order in which the reference's scatter meets them), never
by a float scatter-add whose order on the card changes from run to run.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

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
    and the shared expert when the config has one."""
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
    return p


def moe_capacity(cfg: ModelConfig, s: int) -> int:
    """Slots per expert and example for a sequence of ``s`` tokens."""
    k = cfg.num_experts_per_tok
    cap = max(k, int(-(-s * k * cfg.capacity_factor // cfg.num_experts)))
    return min(cap, s * k)


def _expert_matmul(w, h: torch.Tensor, mode: QuantMode, backend: str) -> torch.Tensor:
    """h (E, C', k) @ w (E, k, n) -> (E, C', n) in h's dtype, one expert
    at a time; ``w`` an expert-stacked QTensor or a ``{"w": ...}`` leaf."""
    if isinstance(w, QTensor):
        ys = [packed_matmul_any(w.period(i), h[i], backend) for i in range(h.shape[0])]
        return torch.stack(ys).to(h.dtype)
    w = w["w"] if isinstance(w, dict) else w
    if mode.is_float:
        ct = torch.bfloat16 if mode == QuantMode.BF16 else torch.float32
        return einsum_f32("eck,ekn->ecn", h.to(ct), w.to(ct)).to(h.dtype)
    ys = [ops.quantized_matmul(h[i].to(torch.float32), w[i].to(torch.float32), mode,
                               backend) for i in range(h.shape[0])]
    return torch.stack(ys).to(h.dtype)


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


def moe_ffn(params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
            policy: QuantPolicy) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux loss float32 scalar).  On a
    sequence-parallel split x and y are this rank's sequence shard."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    dev = x.device
    tp = sharding.tp_split("ffn")

    logits = einsum_f32("bsd,de->bse", x, params["router"])
    probs = sharding.seq_gather(torch.softmax(logits, dim=-1))
    # the whole sequence: the rows the dispatch reads (float32 holding x's
    # values on a tensor-parallel split)
    xw = sharding.tp_enter(x) if tp is not None else x
    b, s, d = xw.shape
    sk = s * k
    cap = moe_capacity(cfg, s)
    # top-k as a stable descending sort: equal probabilities keep the
    # lower expert first, on any device (lax.top_k's order)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    # ---- dispatch (stable sort: position-priority drops) ----
    e_flat = top_i.reshape(b, sk)
    se, order = torch.sort(e_flat, dim=-1, stable=True)
    counts = torch.zeros((b, e), dtype=torch.int64, device=dev).scatter_add_(
        1, e_flat, torch.ones_like(e_flat))                          # (B, E), integers
    starts = counts.cumsum(dim=-1) - counts
    pos = torch.arange(sk, device=dev)[None, :] - torch.gather(starts, 1, se)
    keep = pos < cap
    dest = se * cap + pos.clamp(0, cap - 1)                          # (B, SK)
    tok = order // k
    rows = torch.arange(b, device=dev)[:, None]
    buf = torch.zeros((b, e * cap + 1, d), dtype=xw.dtype, device=dev)
    buf[rows, torch.where(keep, dest, e * cap)] = xw[rows, tok]      # slot e*cap: scratch
    buf = buf[:, :e * cap]

    # ---- expert products ----
    h_in = buf.reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)
    y_sh = None
    if tp is not None:
        y_e, y_sh = _experts_tp(params, h_in, xw, cfg, policy, x.dtype)
    else:
        mode, backend = policy.ffn_proj, policy.backend_for("ffn_proj")
        g = _expert_matmul(params["gate"], h_in, mode, backend)
        u = _expert_matmul(params["up"], h_in, mode, backend)
        h = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
        y_e = _expert_matmul(params["down"], h, mode, backend)        # (E, B*cap, D)
    y_buf = y_e.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)

    # ---- combine, in a fixed order ----
    w_sorted = torch.gather(top_p.reshape(b, sk), 1, order)
    contrib = (y_buf[rows, dest] * keep[..., None].to(y_buf.dtype)
               * w_sorted[..., None].to(y_buf.dtype))                 # (B, SK, D)
    # sorted entry j holds (token tok[j], choice order[j] % k); a token's k
    # entries come in increasing expert id, so read them back in that order
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(sk, device=dev).expand(b, sk))
    slots = torch.sort(rank.reshape(b, s, k), dim=-1).values          # (B, S, k)
    per_tok = contrib[rows[:, :, None], slots]                        # (B, S, k, D)
    y = torch.zeros((b, s, d), dtype=y_buf.dtype, device=dev)
    for j in range(k):
        y = y + per_tok[:, :, j]

    if y_sh is not None:
        y = y + y_sh
    elif cfg.shared_expert_d_ff:
        y = y + ffn(params["shared"], x, policy)
    if tp is not None:
        y = sharding.constrain(y, ("batch", "seq", "embed"))

    # ---- load-balancing aux loss (Switch eq. 4) ----
    split = sharding.batch_split()
    if split is None or not split.axes:
        frac_tokens = counts.sum(dim=0).to(torch.float32) / (b * sk)  # mean of the one-hots
        frac_probs = probs.mean(dim=(0, 1))
    else:
        # a split batch: the global batch's fractions, from the counts and
        # the probability sums of every rank's rows (not linear in the rows)
        n = split.reduce(torch.tensor([b * sk, b * s], dtype=torch.int64, device=dev))
        frac_tokens = split.reduce(counts.sum(dim=0)).to(torch.float32) / n[0].to(torch.float32)
        frac_probs = sharding.sum_over_batch(probs.sum(dim=(0, 1))) / n[1].to(torch.float32)
    aux = e * (frac_tokens * frac_probs).sum() * cfg.router_aux_loss
    return y, aux
