"""Plain PyTorch reference of Mamba2 (arXiv:2405.21060; the SSD mixer, no
FFN) under the ternary (``tnn``) policy, for prefill and for QAT steps,
and the benchmark's parameters and tokens for it.

Imports nothing of the program.  Parameters are made here from the seed
in the layout the port's ``models/model.py`` takes (every per-layer leaf
stacked over the layers), so both sides get the same tensors.

One layer, as the configuration states it: the residual stream in
``cfg["dtype"]`` (bfloat16); ``h = rmsnorm(x)``; ``in_proj`` and
``out_proj`` ternary GeMMs (activations per tensor and weights per
output column by the TWN rule: threshold 0.7 mean|v|, scale the mean
|v| above it; the exact integer product times both scales), their
outputs rounded to the stream's type; the depthwise causal conv and SiLU
on x, B and C; ``dt = softplus(dt + dt_bias)``; the SSD scan written as
its quadratic form over the whole sequence,
``y_t = sum_{j<=t} (C_t . B_j) exp(cum_t - cum_j) dt_j x_j`` with
``cum`` the running sum of ``dt * -exp(A_log)`` (the recurrence
``h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t h_t``
unrolled); ``+ D x``; times SiLU(z); the gated RMSNorm; the residual
add.  Then the final RMSNorm and the tied head (bf16 operands, float32
products).  Everything the configuration states as float32 runs in
``float_dtype`` (float32; bfloat16 is the control), matrix products with
TF32 off.

Training (:func:`train_steps`): float32 masters; each step's compute
copies round every leaf of two or more dims to bfloat16 (the stacked
per-layer leaves, the embedding), as the configuration states; the
ternary GeMMs' backward is straight-through (``gx = g w^T`` masked to
``|x| <= 1``, ``gw = x^T g``, float32); the mean token cross-entropy;
AdamW (linear warm-up, global-norm clipping, decoupled weight decay) in
float32.  Each layer runs under ``torch.utils.checkpoint`` so the
activations of one layer are alive at a time.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gpubench.reference.lowbit import sub_seed, ternary

__all__ = ["sub_seed", "dims", "embed_rows", "make_params", "make_tokens", "leaf",
           "layer_params", "embed", "layer", "final_logits", "head", "layer_vjp", "head_vjp",
           "train_steps", "LEAVES", "BLOCK_LEAVES"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the parameter leaves, by path in the port's tree
LEAVES = ("embed", "pre_mixer_norm/scale", "in_proj/w", "conv_w", "conv_b", "A_log", "D",
          "dt_bias", "norm", "out_proj/w", "final_norm/scale")
# the leaves of one layer
BLOCK_LEAVES = LEAVES[1:-1]


def dims(cfg: dict):
    """(d_inner, groups, state, head dim, heads, conv channels)."""
    din = cfg["ssm_expand"] * cfg["d_model"]
    g, n, p = cfg["ssm_ngroups"], cfg["ssm_state"], cfg["ssm_headdim"]
    return din, g, n, p, din // p, din + 2 * g * n


def embed_rows(cfg: dict) -> int:
    """The embedding's rows: the vocabulary padded to a multiple of 128,
    as the port's ``ShardLayout.pad_vocab`` pads it on one device."""
    return -(-cfg["vocab_size"] // 128) * 128


def make_params(cfg: dict, seed: int, device, dtype) -> Dict[str, Any]:
    """Random parameters in the port's tree: "embed" (rows, d), "blocks":
    [one tree of (layers, ...) leaves], "final_norm".  Projections,
    the conv and the embedding N(0, fan_in^-1) (the embedding d^-1), made
    in ``dtype`` a whole stack per draw; A_log = log(1..16) over the
    heads, D = 1, dt_bias = softplus^-1 of a log-uniform dt in [1e-3,
    1e-1] in float32; norms 1 and the conv bias 0 in ``dtype``."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    d, L = cfg["d_model"], cfg["num_layers"]
    din, gr, n, p, h, conv_dim = dims(cfg)
    f32 = torch.float32

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(std)

    u = torch.rand((L, h), generator=g, device=device)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(u * (hi - lo) + lo)
    mixer = {
        "in_proj": {"w": normal((L, d, 2 * din + 2 * gr * n + h), d ** -0.5)},
        "conv_w": normal((L, cfg["ssm_conv"], conv_dim), cfg["ssm_conv"] ** -0.5),
        "conv_b": torch.zeros((L, conv_dim), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)).repeat(L, 1),
        "D": torch.ones((L, h), dtype=f32, device=device),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm": torch.ones((L, din), dtype=dtype, device=device),
        "out_proj": {"w": normal((L, din, d), din ** -0.5)},
    }
    return {"embed": normal((embed_rows(cfg), d), d ** -0.5),
            "blocks": [{"pre_mixer_norm": {"scale": torch.ones((L, d), dtype=dtype,
                                                                device=device)},
                        "mixer": mixer}],
            "final_norm": {"scale": torch.ones((d,), dtype=dtype, device=device)}}


def make_tokens(cfg: dict, seed: int, count: int, batch: int, length: int) -> np.ndarray:
    """(count, batch, length) int64 token ids, uniform over the vocabulary."""
    rng = np.random.default_rng(sub_seed(seed, 2))
    return rng.integers(0, cfg["vocab_size"], size=(count, batch, length), dtype=np.int64)


def leaf(params, path: str) -> torch.Tensor:
    """A leaf of the tree by its ``LEAVES`` path."""
    if path == "embed":
        return params["embed"]
    if path == "final_norm/scale":
        return params["final_norm"]["scale"]
    return block_leaf(params["blocks"][0], path)


def block_leaf(blk, path: str) -> torch.Tensor:
    """A leaf of one block's tree (stacked or one layer's) by its path."""
    if path == "pre_mixer_norm/scale":
        return blk["pre_mixer_norm"]["scale"]
    node = blk["mixer"]
    for part in path.split("/"):
        node = node[part]
    return node


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------

def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, fdt) -> torch.Tensor:
    v = x.to(fdt)
    return (v * torch.rsqrt((v * v).mean(dim=-1, keepdim=True) + eps)) * scale.to(fdt)


def _ternary_forward(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    xt, sa = ternary(x2.to(torch.float32))
    wt, sw = ternary(w.to(torch.float32), 0)
    return ((xt @ wt) * sa) * sw


class _TernarySTE(torch.autograd.Function):
    """The ternary GeMM forward with the straight-through backward."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return _ternary_forward(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(torch.float32)
        x32 = x2.to(torch.float32)
        gx = (g @ w.to(torch.float32).t()) * (x32.abs() <= 1.0)
        return gx.to(x2.dtype), (x32.t() @ g).to(w.dtype)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., k) -> (..., n) ternary GeMM, rounded to ``x``'s type."""
    y = _TernarySTE.apply(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (K, C)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i:i + s] * w[i] for i in range(k)) + b


def _ssd(xin, bmat, cmat, dt, a, fdt):
    """The scan's quadratic form.  xin (B,S,H,P), bmat/cmat (B,S,G,N), dt
    and a (B,S,H) -> (B,S,H,P)."""
    bsz, s, h, p = xin.shape
    grp = bmat.shape[2]
    cum = torch.cumsum(dt * a, dim=1).transpose(1, 2)                   # (B,H,S)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=xin.device))
    decay = torch.exp(torch.where(causal, cum[..., :, None] - cum[..., None, :],
                                  torch.tensor(float("-inf"), dtype=fdt, device=xin.device)))
    cb = torch.einsum("bign,bjgn->bgij", cmat, bmat)                    # (B,G,S,S)
    cb = cb.repeat_interleave(h // grp, dim=1)                          # (B,H,S,S)
    mix = cb * decay * dt.transpose(1, 2)[:, :, None, :]
    return torch.einsum("bhij,bjhp->bihp", mix, xin)


def _mixer(p, x: torch.Tensor, cfg: dict, fdt) -> torch.Tensor:
    """The SSD mixer on the normed stream x (B, S, D) -> (B, S, D)."""
    din, gr, n, hd, h, conv_dim = dims(cfg)
    bsz, s, _ = x.shape
    zxbcdt = _project(x, p["in_proj"]["w"])
    z, xbc, dt = zxbcdt[..., :din], zxbcdt[..., din:din + conv_dim], zxbcdt[..., din + conv_dim:]
    xbc = F.silu(_causal_conv(xbc.to(fdt), p["conv_w"].to(fdt), p["conv_b"].to(fdt)))
    xin = xbc[..., :din].reshape(bsz, s, h, hd)
    bmat = xbc[..., din:din + gr * n].reshape(bsz, s, gr, n)
    cmat = xbc[..., din + gr * n:].reshape(bsz, s, gr, n)
    dt = F.softplus(dt.to(fdt) + p["dt_bias"].to(fdt))
    a = -torch.exp(p["A_log"]).to(fdt)
    y = _ssd(xin, bmat, cmat, dt, a, fdt)
    y = y + xin * p["D"].to(fdt)[None, None, :, None]
    y = y.reshape(bsz, s, din) * F.silu(z.to(fdt))
    y = _rms_norm(y, p["norm"], cfg["norm_eps"], fdt)
    return _project(y.to(x.dtype), p["out_proj"]["w"])


def _layer(p, x: torch.Tensor, cfg: dict, fdt) -> torch.Tensor:
    h = _rms_norm(x, p["pre_mixer_norm"]["scale"], cfg["norm_eps"], fdt).to(x.dtype)
    return x + _mixer(p["mixer"], h, cfg, fdt)


def _unbind(tree, n: int) -> List[Any]:
    """The ``n`` layers of a stacked tree, each leaf unbound once (so its
    backward is one stack, not a full-size zero tensor per layer)."""
    if isinstance(tree, dict):
        per = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _hidden(params, tokens: torch.Tensor, cfg: dict, fdt, remat: bool) -> torch.Tensor:
    sdt = DTYPES[cfg["dtype"]]
    x = params["embed"][tokens].to(sdt)
    for p in _unbind(params["blocks"][0], cfg["num_layers"]):
        x = checkpoint(_layer, p, x, cfg, fdt, use_reentrant=False) if remat \
            else _layer(p, x, cfg, fdt)
    return _rms_norm(x, params["final_norm"]["scale"], cfg["norm_eps"], fdt).to(sdt)


def _head(params, hidden: torch.Tensor, vocab: int) -> torch.Tensor:
    w = params["embed"][:vocab].to(torch.bfloat16).to(torch.float32)
    return hidden.to(torch.bfloat16).to(torch.float32) @ w.t()


@contextlib.contextmanager
def _tf32(on: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Stage by stage, from given inputs (the check follows the program's own
# layer inputs: a ternary network's last bits decide thresholds, so two
# sound runs part ways over 48 layers)
# ---------------------------------------------------------------------------

def layer_params(params, cfg: dict, compute_copies: bool = False) -> List[Any]:
    """Each layer's parameters (with ``compute_copies``, as a QAT step
    computes with them: every stacked leaf rounded to bfloat16)."""
    blocks = _compute_copies(params)["blocks"] if compute_copies else params["blocks"]
    return _unbind(blocks[0], cfg["num_layers"])


@torch.no_grad()
def embed(params, tokens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The first layer's input: the tokens' embedding rows in the stream's
    type."""
    return params["embed"][tokens].to(DTYPES[cfg["dtype"]])


@torch.no_grad()
def layer(p, x: torch.Tensor, cfg: dict, float_dtype=torch.float32,
          tf32: bool = False) -> torch.Tensor:
    """One layer's output from its input ``x`` (B, S, D)."""
    with _tf32(tf32):
        return _layer(p, x, cfg, float_dtype)


@torch.no_grad()
def final_logits(params, x: torch.Tensor, cfg: dict, float_dtype=torch.float32) -> torch.Tensor:
    """The last layer's output ``x`` (B, S, D) -> the final norm and the
    head at the last position: (B, vocab) float32 logits."""
    with _tf32(False):
        h = _rms_norm(x[:, -1], params["final_norm"]["scale"], cfg["norm_eps"], float_dtype)
        return head(params, h.to(DTYPES[cfg["dtype"]]), cfg, float_dtype)


@torch.no_grad()
def head(params, hidden: torch.Tensor, cfg: dict, float_dtype=torch.float32) -> torch.Tensor:
    """Normed rows (B, D) -> (B, vocab) float32 logits: bf16 operands,
    products and sums in ``float_dtype``."""
    w = params["embed"][:cfg["vocab_size"]].to(torch.bfloat16).to(float_dtype)
    with _tf32(False):
        return (hidden.to(torch.bfloat16).to(float_dtype) @ w.t()).to(torch.float32)


def _with_grad(tree):
    """``tree`` with every leaf a fresh leaf that requires its gradient."""
    if isinstance(tree, dict):
        return {k: _with_grad(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


def layer_vjp(p, x: torch.Tensor, g: torch.Tensor, cfg: dict,
              tf32_backward: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One QAT layer's backward from its input ``x`` and the cotangent
    ``g`` of its output, with the layer's parameters ``p`` (its compute
    copies): (the cotangent of ``x``, {leaf path: gradient}).  The forward
    runs with TF32 off; ``tf32_backward`` gives the backward's products
    TF32 (the control of the backward alone)."""
    p = _with_grad(p)
    x = x.detach().requires_grad_(True)
    paths = BLOCK_LEAVES
    with torch.enable_grad():
        with _tf32(False):
            y = _layer(p, x, cfg, torch.float32)
        with _tf32(tf32_backward):
            grads = torch.autograd.grad(y, [x] + [block_leaf(p, q) for q in paths],
                                        g.to(y.dtype))
    return grads[0], dict(zip(paths, grads[1:]))


def head_vjp(params, x: torch.Tensor, labels: torch.Tensor, cfg: dict,
             tf32_backward: bool = False) -> Tuple[float, torch.Tensor]:
    """The QAT loss from the last layer's output ``x`` (B, S, D): the final
    norm, the tied head, the mean token cross-entropy, with the step's
    compute copies ``params``; (loss, the cotangent of ``x``)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        with _tf32(False):
            h = _rms_norm(x, params["final_norm"]["scale"], cfg["norm_eps"], torch.float32)
            b, s, d = x.shape
            logits = _head(params, h.to(x.dtype).reshape(b * s, d), cfg["vocab_size"])
            loss = F.cross_entropy(logits, labels.reshape(-1).long())
        with _tf32(tf32_backward):
            (gx,) = torch.autograd.grad(loss, [x])
    return float(loss.detach()), gx


# ---------------------------------------------------------------------------
# QAT steps
# ---------------------------------------------------------------------------

def _compute_copies(params):
    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        if isinstance(t, list):
            return [cast(v) for v in t]
        return t.to(torch.bfloat16) if t.ndim >= 2 else t
    return cast(params)


def _flat(tree) -> List[torch.Tensor]:
    return [leaf(tree, path) for path in LEAVES]


def _loss(params, batch, cfg: dict, fdt) -> torch.Tensor:
    tokens, labels = batch
    copies = _compute_copies(params)
    hidden = _hidden(copies, tokens, cfg, fdt, remat=True)
    b, s, d = hidden.shape
    logits = _head(copies, hidden.reshape(b * s, d), cfg["vocab_size"])
    return F.cross_entropy(logits, labels.reshape(-1))


def train_steps(cfg: dict, opt: dict, params, batches: List[Tuple[torch.Tensor, torch.Tensor]],
                matmul_tf32: bool = False) -> Dict[str, Any]:
    """Run one QAT step per batch ((tokens, labels), each (B, S)) from the
    float32 masters ``params`` (updated in place).  Returns {"loss": [per
    step], "gnorm": [the global gradient norm per step, before clipping],
    "m1": [the norm of each leaf's first moment after step 1 (its
    clipped gradient times 1 - b1)]}, leaves in ``LEAVES`` order."""
    with _tf32(matmul_tf32):
        flat = _flat(params)
        m = [torch.zeros_like(t) for t in flat]
        v = [torch.zeros_like(t) for t in flat]
        out: Dict[str, Any] = {"loss": [], "gnorm": []}
        for step, batch in enumerate(batches, start=1):
            for t in flat:
                t.requires_grad_(True)
            with torch.enable_grad():
                loss = _loss(params, batch, cfg, torch.float32)
                grads = torch.autograd.grad(loss, flat)
            for t in flat:
                t.requires_grad_(False)
            out["loss"].append(float(loss.detach()))
            with torch.no_grad():
                gnorm = torch.sqrt(sum(torch.sum(gg.to(torch.float32) ** 2) for gg in grads))
                out["gnorm"].append(float(gnorm))
                clip = torch.clamp(opt["clip_norm"] / torch.clamp(gnorm, min=1e-12), max=1.0)
                lr = opt["lr"] * min(step / max(1.0, opt["warmup_steps"]), 1.0) \
                    if step < opt["warmup_steps"] else _cosine(opt, step)
                c1, c2 = 1 - opt["b1"] ** step, 1 - opt["b2"] ** step
                for i, (p, gg) in enumerate(zip(flat, grads)):
                    gg = gg.to(torch.float32) * clip
                    m[i] = opt["b1"] * m[i] + (1 - opt["b1"]) * gg
                    v[i] = opt["b2"] * v[i] + (1 - opt["b2"]) * gg * gg
                    delta = (m[i] / c1) / (torch.sqrt(v[i] / c2) + opt["eps"])
                    p.sub_(lr * (delta + opt["weight_decay"] * p))
                if step == 1:
                    out["m1"] = [float(torch.linalg.vector_norm(t)) for t in m]
            del grads
        return out


def _cosine(opt: dict, step: int) -> float:
    t = min(max((step - opt["warmup_steps"]) / max(1.0, opt["total_steps"] - opt["warmup_steps"]),
                0.0), 1.0)
    frac = opt["min_lr_frac"]
    return opt["lr"] * (frac + (1 - frac) * 0.5 * (1 + math.cos(math.pi * t)))
