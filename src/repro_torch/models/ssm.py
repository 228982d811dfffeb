"""Mamba2 / SSD (state-space duality) mixer: chunked scan for a prompt,
one-step recurrence for decode.

Counterpart of ``repro/models/ssm.py``.  The SSD core (the A, dt, B, C
recurrence) is elementwise and scan math, not a GeMM, so the paper's
low-bit technique does not apply to it; the in/out projections around it
run through ``attention.project`` (``qmm`` on packed weights,
``quantized_matmul`` on master weights).  The depthwise causal conv is
plain PyTorch.

Chunked SSD (Mamba2 paper, §6): the sequence splits into chunks of Q
steps; within a chunk the recurrence expands into a (Q x Q) masked
"attention" form; across chunks a loop carries the (G, Hg, N, P) state
(the reference's ``lax.scan``).  Every product is a float32 one
(``einsum_f32``: TF32 off).

On a tensor-parallel split of "ssm_heads" (the training mesh) each rank
computes its heads (:func:`_tp_dims`): the sequence is gathered before
``in_proj`` (the scan runs along all of it), ``in_proj`` runs
column-parallel on the rank's columns (its heads' z, x and dt and the B
and C of its heads' groups, taken from the whole weight; an INT8/INT4
grid is the whole weight's, with no collective), the conv on
its channels, the scan and the D skip on its heads, the gated RMSNorm
over all of d_inner with its sum of squares summed over the axis
(``sharding.tp_all_reduce``, float32), and ``out_proj`` row-parallel back
into sequence shards.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.modes import DEFAULT_DEVICE, QuantMode, resolve_device
from repro_torch.models.attention import project
from repro_torch.models.common import ModelConfig, einsum_f32, rms_norm
from repro_torch.parallel import sharding

__all__ = ["init_ssm", "ssm_forward", "ssm_decode", "init_ssm_state"]


def _dims(cfg: ModelConfig):
    din = cfg.ssm_d_inner
    g, n, p = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    h = cfg.ssm_nheads
    assert h % g == 0, "ssm heads must split into groups"
    return din, g, n, p, h, din + 2 * g * n


def init_ssm(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device=DEFAULT_DEVICE) -> Dict[str, Any]:
    dev = resolve_device(device)
    d = cfg.d_model
    din, g, n, p, h, conv_dim = _dims(cfg)

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dtype)

    u = torch.rand((h,), generator=generator, device=dev)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(u * (hi - lo) + lo)
    return {
        "in_proj": {"w": normal((d, 2 * din + 2 * g * n + h), d ** -0.5)},
        "conv_w": normal((cfg.ssm_conv, conv_dim), cfg.ssm_conv ** -0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "D": torch.ones((h,), device=dev),
        "dt_bias": torch.log(torch.expm1(dt)),          # softplus^-1(dt)
        "norm": torch.ones((din,), dtype=dtype, device=dev),
        "out_proj": {"w": normal((din, d), din ** -0.5)},
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by K static shifts.  x (B,S,C), w (K,C)."""
    k, s = w.shape[0], x.shape[1]
    out = x * w[k - 1]
    for i in range(1, k):
        out = out + F.pad(x, (0, 0, i, 0))[:, :s] * w[k - 1 - i]
    return out + b


def _split_proj(zxbcdt: torch.Tensor, dims):
    din, g, n, p, h, conv_dim = dims
    return (zxbcdt[..., :din], zxbcdt[..., din:din + conv_dim],
            zxbcdt[..., din + conv_dim:])


def _tp_dims(cfg: ModelConfig, tp: int, j: int, device):
    """Rank ``j`` of ``tp``'s share of the mixer: its ``_dims`` (d_inner,
    groups, state, head dim, heads, conv channels of its own), the columns
    of ``in_proj`` it computes ([z | x | B | C | dt] of its heads and of
    its heads' groups) and the conv channels ([x | B | C]).  Its heads are
    the j-th ``h / tp``; its groups the j-th ``g / tp`` when the groups
    split, else the one group its heads lie in."""
    din, g, n, p, h, conv_dim = _dims(cfg)
    hl = h // tp
    gl = g // tp if g % tp == 0 else 1
    g0 = j * gl if g % tp == 0 else (j * hl) // (h // g)
    dl = hl * p

    def rng(start, length):
        return torch.arange(start, start + length, device=device)

    xr, br, cr = rng(j * dl, dl), rng(din + g0 * n, gl * n), rng(din + g * n + g0 * n, gl * n)
    cols = torch.cat([xr, din + xr, din + br, din + cr, rng(2 * din + 2 * g * n + j * hl, hl)])
    return (dl, gl, n, p, hl, dl + 2 * gl * n), cols, torch.cat([xr, br, cr])


def ssm_forward(params, x: torch.Tensor, cfg: ModelConfig, policy: QuantPolicy, *,
                return_state: bool = False):
    """x (B, S, D) -> (B, S, D) by chunked SSD.  With ``return_state``
    also the decode state after position S-1 ({"conv", "h"}), so a
    prefill seeds decoding."""
    mode, backend = policy.ssm_proj, policy.backend_for("ssm_proj")
    f32 = torch.float32
    dtype = x.dtype
    tp = sharding.tp_split("ssm_heads")
    if tp is None:
        dims = _dims(cfg)
        zxbcdt = project(params["in_proj"], x, mode, backend)
        conv_w, conv_b = params["conv_w"], params["conv_b"]
    else:
        if return_state:
            raise NotImplementedError("ssm_forward: return_state on a tensor-parallel split")
        # the whole sequence (float32 holding x's values), this rank's heads
        x = sharding.tp_enter(x)
        dims, cols, chans = _tp_dims(cfg, tp.tp_size, tp.tp_index, x.device)
        whole = params["in_proj"]["w"]
        # an INT8/INT4 grid spans the whole in_proj, which every rank holds
        stats = ({"w": ops.affine_weight_stats(whole, mode)}
                 if mode in (QuantMode.INT8, QuantMode.INT4) else None)
        zxbcdt = project({"w": whole.index_select(1, cols)}, x, mode, backend, "col",
                         stats).to(dtype)
        conv_w, conv_b = params["conv_w"].index_select(1, chans), params["conv_b"][chans]
    with obs.annotate("repro_torch.ssd"):
        b, s, d = x.shape
        din, g, n, p, h, conv_dim = dims
        hg = h // g
        q = min(cfg.ssm_chunk, s)
        assert s % q == 0, f"seq {s} must be a multiple of ssm_chunk {q}"
        nc = s // q

        z, xbc_raw, dt = _split_proj(zxbcdt, dims)
        xbc = F.silu(_causal_conv(xbc_raw.to(f32), conv_w.to(f32), conv_b.to(f32)))
        xin = xbc[..., :din].reshape(b, s, g, hg, p)
        bmat = xbc[..., din:din + g * n].reshape(b, s, g, n)
        cmat = xbc[..., din + g * n:].reshape(b, s, g, n)
        dt = F.softplus(dt.to(f32) + params["dt_bias"])                  # (B,S,H)
        da = dt * -torch.exp(params["A_log"])                            # (B,S,H)

        xin_c = xin.reshape(b, nc, q, g, hg, p)
        b_c = bmat.reshape(b, nc, q, g, n)
        c_c = cmat.reshape(b, nc, q, g, n)
        dt_c = dt.reshape(b, nc, q, g, hg)
        cum = torch.cumsum(da.reshape(b, nc, q, g, hg), dim=2)           # (B,nc,Q,G,Hg)

        # ---- intra-chunk (quadratic in Q only) ----
        cb = einsum_f32("bcign,bcjgn->bcgij", c_c, b_c)                  # (B,nc,G,Q,Q)
        ci = cum.permute(0, 1, 3, 4, 2)                                  # (B,nc,G,Hg,Q)
        decay = torch.exp(torch.clamp(ci[..., :, None] - ci[..., None, :], -60.0, 0.0))
        mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
        scores = cb[:, :, :, None] * decay * torch.where(mask, 1.0, 0.0)
        scores = scores * dt_c.permute(0, 1, 3, 4, 2)[..., None, :]      # weight by dt_j
        y_intra = einsum_f32("bcghij,bcjghp->bcighp", scores, xin_c)

        # ---- chunk states ----
        decay_to_end = torch.exp(torch.clamp(ci[..., -1:] - ci, -60.0, 0.0))
        xw = xin_c * (dt_c * decay_to_end.permute(0, 1, 4, 2, 3))[..., None]
        s_c = einsum_f32("bcjgn,bcjghp->bcghnp", b_c, xw)                # (B,nc,G,Hg,N,P)

        # ---- inter-chunk loop ----
        chunk_decay = torch.exp(torch.clamp(cum[:, :, -1], min=-60.0))   # (B,nc,G,Hg)
        hstate = torch.zeros((b, g, hg, n, p), dtype=f32, device=x.device)
        h_prevs = []
        for c in range(nc):
            h_prevs.append(hstate)
            hstate = hstate * chunk_decay[:, c, ..., None, None] + s_c[:, c]
        h_prevs = torch.stack(h_prevs, dim=1)                            # (B,nc,G,Hg,N,P)

        decay_from_start = torch.exp(torch.clamp(cum, min=-60.0))        # (B,nc,Q,G,Hg)
        y_inter = einsum_f32("bcign,bcghnp->bcighp", c_c, h_prevs)
        y_inter = y_inter * decay_from_start[..., None]

        y = (y_intra + y_inter).reshape(b, s, g, hg, p)
        y = y + xin * params["D"].reshape(g, hg)[None, None, :, :, None]
        y = y.reshape(b, s, din) * F.silu(z.to(f32))
        if tp is None:
            y = rms_norm(y, params["norm"].to(f32), cfg.norm_eps)
            role = None
        else:
            # the gated norm spans all of d_inner: its sum of squares over the axis
            var = sharding.tp_all_reduce((y * y).sum(dim=-1, keepdim=True)) / (din * tp.tp_size)
            y = (y * torch.rsqrt(var + cfg.norm_eps)) * params["norm"].to(f32)
            role = "row"
    out = project(params["out_proj"], y.to(dtype), mode, backend, role)
    if return_state:
        kc = cfg.ssm_conv - 1
        return out, {"conv": xbc_raw[:, s - kc:].to(f32), "h": hstate}
    return out


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    din, g, n, p, h, conv_dim = _dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=dev),
            "h": torch.zeros((batch, g, h // g, n, p), dtype=torch.float32, device=dev)}


def ssm_decode(params, x: torch.Tensor, cfg: ModelConfig, policy: QuantPolicy,
               state) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, 1, D) -> (y (B, 1, D), the new state): one recurrence step."""
    b = x.shape[0]
    din, g, n, p, h, conv_dim = _dims(cfg)
    hg = h // g
    mode, backend = policy.ssm_proj, policy.backend_for("ssm_proj")
    f32 = torch.float32

    zxbcdt = project(params["in_proj"], x, mode, backend)
    z, xbc, dt = _split_proj(zxbcdt[:, 0], _dims(cfg))                      # (B, ...)
    window = torch.cat([state["conv"], xbc[:, None, :].to(state["conv"].dtype)], dim=1)
    conv_out = einsum_f32("bkc,kc->bc", window, params["conv_w"])
    xbc_t = F.silu(conv_out + params["conv_b"].to(f32))

    xin = xbc_t[:, :din].reshape(b, g, hg, p)
    bmat = xbc_t[:, din:din + g * n].reshape(b, g, n)
    cmat = xbc_t[:, din + g * n:].reshape(b, g, n)
    dt = F.softplus(dt.to(f32) + params["dt_bias"])                  # (B,H)
    dec = torch.exp((dt * -torch.exp(params["A_log"])).reshape(b, g, hg))

    dbx = einsum_f32("bgn,bghp->bghnp", bmat, xin * dt.reshape(b, g, hg)[..., None])
    h_new = state["h"] * dec[..., None, None] + dbx
    y = einsum_f32("bgn,bghnp->bghp", cmat, h_new)
    y = y + xin * params["D"].reshape(g, hg)[None, :, :, None]
    y = y.reshape(b, din) * F.silu(z.to(f32))
    y = rms_norm(y, params["norm"].to(f32), cfg.norm_eps)
    y = project(params["out_proj"], y[:, None, :].to(x.dtype), mode, backend)
    return y, {"conv": window[:, 1:], "h": h_new}
