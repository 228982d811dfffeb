"""Plain PyTorch reference of Qwen1.5-MoE-A2.7B (hf ``Qwen/Qwen1.5-MoE-A2.7B``:
the Qwen2-MoE decoder) under the ternary (``tnn``) policy, for packed
prefill, and the benchmark's parameters and tokens for it.

Imports nothing of the program.  Parameters are made here from the seed
in the layout the port's ``models/model.py`` takes (every per-layer leaf
stacked over the layers), so both sides get the same tensors.

One layer, as the published decoder layer computes it, with the
residual stream in ``cfg["dtype"]`` (bfloat16):

* ``h = rmsnorm(x)`` (eps ``norm_eps``), rounded to the stream's type;
* q, k, v: ternary GeMMs of h plus their biases, rounded; RoPE
  (rotate-half, ``rope_theta``) on q and k, rounded; causal softmax
  attention over the prompt, ``softmax(q k^T / sqrt(dh)) v``, rounded;
  ``wo``; the residual add;
* ``h = rmsnorm(x)``; the router's probabilities ``softmax(h w_router)``,
  the top ``num_experts_per_tok`` of them (descending, the lower expert
  first on equal values), not renormalised; each routed expert on
  exactly its routed rows (dropless): ``down(SiLU(gate h) * up h)``, each
  product rounded; the shared expert on every row likewise, times
  ``sigmoid(h w_gate)``; ``sum_i p_i y_i`` over a token's experts in
  increasing expert id, plus the gated shared expert, rounded; the
  residual add.

Then the final RMSNorm and the untied head (bf16 operands, float32
products).  A ternary GeMM is the paper's TWN rule (activations per
tensor, over the rows the product sees; weights per output column;
threshold 0.7 mean|v|, scale the mean |v| above it), the exact integer
product times both scales, plus the bias, in float32.  Everything else
the configuration states as float32 (norms, RoPE, the attention's
products and softmax, the router, SiLU, the gate, the combine) runs in
``float_dtype`` (float32; bfloat16 is the control), matrix products
with TF32 off.

Departures from the published model: the projections are ternary (this
repository's policy); the weights are random; the shared expert is the
published single MLP of width 5,632.

Router ties.  Where a token's last chosen and first unchosen
probabilities lie within :data:`TIE_BAND` of each other, the last bits
of the router's sums decide the choice, and either way is sound.
:func:`layer_both` then gives a second output, with every such token's
last choice swapped for the first unchosen expert.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference.lowbit import sub_seed, ternary

__all__ = ["sub_seed", "embed_rows", "make_params", "make_tokens", "layer_params", "embed",
           "layer", "layer_both", "final_logits", "head", "route", "TIE_BAND"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the relative gap (p_k - p_{k+1}) / p_k under which a routing is a tie
TIE_BAND = 1e-3


def embed_rows(cfg: dict) -> int:
    """The embedding's and the head's rows: the vocabulary padded to a
    multiple of 128, as the port's ``ShardLayout.pad_vocab`` pads it on
    one device."""
    return -(-cfg["vocab_size"] // 128) * 128


def _head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]


def make_params(cfg: dict, seed: int, device, dtype) -> Dict[str, Any]:
    """Random parameters in the port's tree: "embed" (rows, d), "blocks":
    [one tree of (layers, ...) leaves], "final_norm", "lm_head" (d, rows).
    Projections N(0, fan_in^-1), the head N(0, 1/d), the embedding
    N(0, 1) (``nn.Embedding``'s own), made in ``dtype`` a whole stack per
    draw; q and k biases N(0, 0.25), v biases N(0, 4e-4) in ``dtype``;
    the router (d, E) and the shared expert's gate (d, 1) N(0, 1/d) in
    float32; norms 1.

    Random weights carry no trained router's balance: what every token's
    stream shares (the v bias through ``wo``, attention's averages)
    grows over the layers and turns every router to the same experts.
    The embedding's scale keeps each token's own part ahead and the v
    bias small, so every expert gets rows in every layer, a few times
    the mean at most."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    d, L, e = cfg["d_model"], cfg["num_layers"], cfg["num_experts"]
    h, kv, dh = cfg["num_heads"], cfg["num_kv_heads"], _head_dim(cfg)
    f, fs = cfg["d_ff"], cfg["shared_expert_d_ff"]

    def normal(shape, std, dt=dtype):
        return torch.randn(shape, generator=g, device=device, dtype=dt).mul_(std)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    mixer = {"wq": {"w": normal((L, d, h * dh), d ** -0.5), "b": normal((L, h * dh), 0.5)},
             "wk": {"w": normal((L, d, kv * dh), d ** -0.5), "b": normal((L, kv * dh), 0.5)},
             "wv": {"w": normal((L, d, kv * dh), d ** -0.5), "b": normal((L, kv * dh), 0.02)},
             "wo": {"w": normal((L, h * dh, d), (h * dh) ** -0.5)}}
    ffn = {"router": normal((L, d, e), d ** -0.5, torch.float32),
           "gate": {"w": normal((L, e, d, f), d ** -0.5)},
           "up": {"w": normal((L, e, d, f), d ** -0.5)},
           "down": {"w": normal((L, e, f, d), f ** -0.5)},
           "shared": {"gate": {"w": normal((L, d, fs), d ** -0.5)},
                      "up": {"w": normal((L, d, fs), d ** -0.5)},
                      "down": {"w": normal((L, fs, d), fs ** -0.5)}},
           "shared_gate": normal((L, d, 1), d ** -0.5, torch.float32)}
    rows = embed_rows(cfg)
    return {"embed": normal((rows, d), 1.0),
            "blocks": [{"pre_mixer_norm": {"scale": ones((L, d))}, "mixer": mixer,
                        "pre_ffn_norm": {"scale": ones((L, d))}, "ffn": ffn}],
            "final_norm": {"scale": ones((d,))},
            "lm_head": {"w": normal((d, rows), d ** -0.5)}}


def make_tokens(cfg: dict, seed: int, count: int, batch: int, length: int) -> np.ndarray:
    """(count, batch, length) int64 token ids, uniform over the vocabulary."""
    rng = np.random.default_rng(sub_seed(seed, 2))
    return rng.integers(0, cfg["vocab_size"], size=(count, batch, length), dtype=np.int64)


def _unbind(tree, n: int) -> List[Any]:
    if isinstance(tree, dict):
        per = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def layer_params(params, cfg: dict) -> List[Any]:
    """Each layer's parameters."""
    return _unbind(params["blocks"][0], cfg["num_layers"])


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _tf32_off():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, fdt) -> torch.Tensor:
    v = x.to(fdt)
    return (v * torch.rsqrt((v * v).mean(dim=-1, keepdim=True) + eps)) * scale.to(fdt)


def _project(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """(..., k) -> (..., n) ternary GeMM (activations over every row of
    ``x``) plus ``b`` in float32, rounded to ``x``'s type."""
    x2 = x.reshape(-1, x.shape[-1])
    xt, sa = ternary(x2.to(torch.float32))
    wt, sw = ternary(w.to(torch.float32), 0)
    y = ((xt @ wt) * sa) * sw
    if b is not None:
        y = y + b.to(torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)


def _rope(x: torch.Tensor, theta: float, fdt) -> torch.Tensor:
    """Rotate-half RoPE over positions 0..S-1: x (B, S, H, dh)."""
    s, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).to(fdt)[:, None, :], torch.sin(ang).to(fdt)[:, None, :]
    x1, x2 = x.to(fdt).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _attention(p, h: torch.Tensor, cfg: dict, fdt) -> torch.Tensor:
    bsz, s, _ = h.shape
    nh, kv, dh = cfg["num_heads"], cfg["num_kv_heads"], _head_dim(cfg)
    q = _project(h, p["wq"]["w"], p["wq"]["b"]).reshape(bsz, s, nh, dh)
    k = _project(h, p["wk"]["w"], p["wk"]["b"]).reshape(bsz, s, kv, dh)
    v = _project(h, p["wv"]["w"], p["wv"]["b"]).reshape(bsz, s, kv, dh)
    q, k = _rope(q, cfg["rope_theta"], fdt), _rope(k, cfg["rope_theta"], fdt)
    rep = nh // kv
    k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(fdt), k.to(fdt)) * dh ** -0.5
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=h.device))
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(fdt)).reshape(bsz, s, nh * dh)
    return _project(out.to(h.dtype), p["wo"]["w"])


def route(p, h2: torch.Tensor, cfg: dict, fdt):
    """The router on rows h2 (T, D): (top-k probabilities (T, k) in
    ``fdt``, their experts (T, k), the tied rows (T,) bool, the first
    unchosen expert (T,) and its probability)."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(h2.to(fdt) @ p["router"].to(fdt), dim=-1)
    sp, si = torch.sort(probs, dim=-1, descending=True, stable=True)
    tied = (sp[:, k - 1] - sp[:, k]) <= TIE_BAND * sp[:, k - 1]
    return sp[:, :k], si[:, :k], tied, si[:, k], sp[:, k]


def _swiglu(p, x2: torch.Tensor, fdt) -> torch.Tensor:
    g = _project(x2, p["gate"]["w"])
    u = _project(x2, p["up"]["w"])
    a = (F.silu(g.to(fdt)) * u.to(fdt)).to(x2.dtype)
    return _project(a, p["down"]["w"])


def _moe(p, h: torch.Tensor, top_p: torch.Tensor, top_i: torch.Tensor, fdt) -> torch.Tensor:
    """The sparse block on h (B, S, D) for the given routing (T, k)."""
    bsz, s, d = h.shape
    h2 = h.reshape(-1, d)
    y = torch.zeros((h2.shape[0], d), dtype=fdt, device=h.device)
    for e in range(p["router"].shape[-1]):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        expert = {name: {"w": p[name]["w"][e]} for name in ("gate", "up", "down")}
        ye = _swiglu(expert, h2[tok], fdt)
        # a token meets each expert at most once: no two rows add into one
        y.index_add_(0, tok, ye.to(fdt) * top_p[tok, slot][:, None])
    shared = _swiglu(p["shared"], h2, fdt).to(fdt)
    gate = torch.sigmoid(h2.to(fdt) @ p["shared_gate"].to(fdt))
    return (y + shared * gate).reshape(bsz, s, d).to(h.dtype)


def _layer(p, x: torch.Tensor, cfg: dict, fdt, alternative: bool):
    """(the layer's output, the output with tied routings swapped or
    None, the number of tied rows)."""
    h = _rms_norm(x, p["pre_mixer_norm"]["scale"], cfg["norm_eps"], fdt).to(x.dtype)
    x = x + _attention(p["mixer"], h, cfg, fdt)
    h = _rms_norm(x, p["pre_ffn_norm"]["scale"], cfg["norm_eps"], fdt).to(x.dtype)
    top_p, top_i, tied, nxt_i, nxt_p = route(p["ffn"], h.reshape(-1, h.shape[-1]), cfg, fdt)
    out = x + _moe(p["ffn"], h, top_p, top_i, fdt)
    ties = int(tied.sum())
    if not alternative or ties == 0:
        return out, None, ties
    k = top_i.shape[1]
    alt_i, alt_p = top_i.clone(), top_p.clone()
    alt_i[tied, k - 1], alt_p[tied, k - 1] = nxt_i[tied], nxt_p[tied]
    return out, x + _moe(p["ffn"], h, alt_p, alt_i, fdt), ties


# ---------------------------------------------------------------------------
# Stage by stage, from given inputs (the check follows the program's own
# layer inputs: a ternary network's last bits decide thresholds, so two
# sound runs part ways over 24 layers)
# ---------------------------------------------------------------------------

@torch.no_grad()
def embed(params, tokens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The first layer's input: the tokens' embedding rows in the stream's
    type."""
    return params["embed"][tokens].to(DTYPES[cfg["dtype"]])


@torch.no_grad()
def layer(p, x: torch.Tensor, cfg: dict, float_dtype=torch.float32) -> torch.Tensor:
    """One layer's output from its input ``x`` (B, S, D)."""
    with _tf32_off():
        return _layer(p, x, cfg, float_dtype, alternative=False)[0]


@torch.no_grad()
def layer_both(p, x: torch.Tensor, cfg: dict, float_dtype=torch.float32
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """(the layer's output, the output with every tied routing swapped or
    None where there is none, the number of tied rows)."""
    with _tf32_off():
        return _layer(p, x, cfg, float_dtype, alternative=True)


@torch.no_grad()
def final_logits(params, x: torch.Tensor, cfg: dict, float_dtype=torch.float32) -> torch.Tensor:
    """The last layer's output ``x`` (B, S, D) -> the final norm and the
    head at the last position: (B, vocab) float32 logits."""
    h = _rms_norm(x[:, -1], params["final_norm"]["scale"], cfg["norm_eps"], float_dtype)
    return head(params, h.to(DTYPES[cfg["dtype"]]), cfg, float_dtype)


@torch.no_grad()
def head(params, hidden: torch.Tensor, cfg: dict, float_dtype=torch.float32) -> torch.Tensor:
    """Normed rows (B, D) -> (B, vocab) float32 logits: bf16 operands,
    products and sums in ``float_dtype``."""
    w = params["lm_head"]["w"][:, :cfg["vocab_size"]].to(torch.bfloat16).to(float_dtype)
    with _tf32_off():
        return (hidden.to(torch.bfloat16).to(float_dtype) @ w).to(torch.float32)
