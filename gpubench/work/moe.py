"""The least work of a mixture-of-experts decoder's packed prefill (the
published Qwen1.5-MoE block: attention with q/k/v biases, every layer a
sparse block of routed experts and one gated shared expert), from
shapes, with ``roofline.py``'s peaks and GeMM count.

Configurations are plain dicts (the cell's config file).  The routed
experts' GeMMs are counted as one grouped GeMM a projection: the B*S*k
routed rows of a layer in all, whatever each expert's share, and every
expert's weights read once.  A sum of per-expert bounds is never below
that (the largest of two sums is at most the sum of the largest of each
pair), so the share it gives is at most 100%.
"""

from __future__ import annotations

from typing import List, Tuple

from gpubench.work.roofline import NPOPC, Work, gemm_work

__all__ = ["head_dim", "dense_shapes", "routed_shapes", "grouped_gemm_work",
           "prefill_kernel_work", "prefill_step_work"]

_PLANES = {"tnn": (2, 2), "tbn": (2, 1), "bnn": (1, 1)}   # (A planes, B planes)


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]


def _kw(k: int) -> int:
    return -(-k // 32)


def dense_shapes(cfg: dict, m: int) -> List[Tuple[int, int, int, bool]]:
    """(m, n, k, biased) of one layer's projections that see every row:
    q, k, v (biased under ``qkv_bias``), o, and the shared expert's gate,
    up and down."""
    d, dh = cfg["d_model"], head_dim(cfg)
    hq, hkv, fs = cfg["num_heads"] * dh, cfg["num_kv_heads"] * dh, cfg["shared_expert_d_ff"]
    bias = bool(cfg.get("qkv_bias"))
    out = [(m, hq, d, bias), (m, hkv, d, bias), (m, hkv, d, bias), (m, d, hq, False)]
    if fs:
        out += [(m, fs, d, False), (m, fs, d, False), (m, d, fs, False)]
    return out


def routed_shapes(cfg: dict, rows: int) -> List[Tuple[int, int, int]]:
    """(rows, n, k) of one layer's routed expert projections, every routed
    row of the layer in all: gate, up, down."""
    d, f = cfg["d_model"], cfg["d_ff"]
    return [(rows, f, d), (rows, f, d), (rows, d, f)]


def grouped_gemm_work(mode: str, m: int, n: int, kw: int, groups: int) -> Work:
    """``groups`` fused popcount GeMMs over ``m`` rows in all: the rows'
    A planes once, every group's B^T (n, kw) planes and column scale
    once, one row scale a row, (m, n) float32 out."""
    na, nb = _PLANES[mode]
    nbytes = 4 * kw * (m * na + groups * n * nb) + 4 * m * n + 4 * (m + groups * n)
    return Work({"popc": float(m * n * kw * NPOPC[mode])}, float(nbytes))


def prefill_kernel_work(cfg: dict, batch: int, seq: int) -> List[Work]:
    """The fused TNN GeMMs of one prefill, layer by layer: q, k, v (with
    their bias), o and the shared expert's three at B*S rows, the routed
    experts' three at B*S*k rows as grouped GeMMs."""
    m = batch * seq
    rows = m * cfg["num_experts_per_tok"]
    layer = [gemm_work("tnn", mm, n, _kw(k)) + Work({}, 4.0 * n if biased else 0.0)
             for mm, n, k, biased in dense_shapes(cfg, m)]
    layer += [grouped_gemm_work("tnn", r, n, _kw(k), cfg["num_experts"])
              for r, n, k in routed_shapes(cfg, rows)]
    return layer * cfg["num_layers"]


def prefill_step_work(cfg: dict, batch: int, seq: int) -> Work:
    """The least work of one prefill forward: every projection's popcounts;
    float32 products: the router (2 m d E), the shared expert's gate
    (2 m d) and the causal attention's scores and mix (2 B H dh S (S+1));
    the head's bf16 products at the last position; bytes: every packed
    weight (planes and column scales, biases), the router and gate
    weights, the embedding rows of the prompt and the head's table read
    once, the K/V cache (bf16) and the last logits written once, the
    tokens read once."""
    m = batch * seq
    d, v, e, L = cfg["d_model"], cfg["vocab_size"], cfg["num_experts"], cfg["num_layers"]
    dh, h, kv = head_dim(cfg), cfg["num_heads"], cfg["num_kv_heads"]
    k = cfg["num_experts_per_tok"]
    dense, routed = dense_shapes(cfg, m), routed_shapes(cfg, m * k)
    popc = sum(mm * n * _kw(kk) * NPOPC["tnn"] for mm, n, kk, _ in dense) \
        + sum(r * n * _kw(kk) * NPOPC["tnn"] for r, n, kk in routed)
    f32 = 2.0 * m * d * e + 2.0 * m * d + 2.0 * batch * h * dh * seq * (seq + 1)
    planes = sum(2 * 4 * n * _kw(kk) + 4 * n + (4 * n if biased else 0)
                 for _, n, kk, biased in dense) \
        + e * sum(2 * 4 * n * _kw(kk) + 4 * n for _, n, kk in routed)
    per_layer = planes + 4 * d * e + 4 * d + 2 * 2 * m * kv * dh
    nbytes = L * per_layer + 2 * m * d + 2 * d * v + 4 * batch * v + 8 * m
    return Work({"popc": float(L * popc), "f32": float(L * f32),
                 "bf16": 2.0 * batch * d * v}, float(nbytes))
