"""AdamW + cosine schedule + global-norm clipping, functional over the
port's parameter trees.

Counterpart of ``repro/optim/adamw.py``, with its arithmetic in float32
in the same order (so one update agrees with the reference to float32
rounding), and not ``torch.optim``: the optimizer state keeps the
reference's structure — ``{"step", "m", "v"}`` with one moment per
parameter leaf — so the checkpointer writes the reference's keys.

``moments_dtype="int8"`` stores both moments block-quantized to int8
(:class:`Q8`: per-256-block absmax scales, 8-bit-Adam style), cutting
optimizer memory 4x.

:func:`adamw_update` writes the new parameters and moments into the
tensors it is given (under ``torch.no_grad``) and returns them in fresh
trees: at TinyLlama-1.1B width a functional copy of parameters and both
moments would hold another 13 GB at the end of the step.  A caller that
needs the old values clones them first.  A large leaf is updated a slice
of its leading dim at a time (:data:`_UPDATE_ELEMS`): every op of the
update is elementwise or within a block of the last dim, so the result is
the whole leaf's, with one slice's float32 temporaries alive (a
period-stacked Mamba2-1.3B ``in_proj`` holds 837 M elements: ~8
temporaries of 3.35 GB each done whole).

Division: a float32 scalar divided by a tensor is written as a tensor
division (``f32_scalar(a) / t``); PyTorch's ``a / t`` multiplies by the
reciprocal, which rounds twice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.quantize import f32_scalar
from repro_torch.parallel.sharding import holds_first_copy, mesh_coord, spec_axes
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "Q8", "Q8Layout", "q8_layouts", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "clip_by_global_norm"]

_BLOCK = 256  # int8 moment quantization block (over the last dim)
# the most elements of a leaf one step of the update touches at once
_UPDATE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    moments_dtype: str = "f32"       # "f32" | "int8"


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr``, then cosine decay to ``min_lr_frac * lr``:
    a float32 scalar on ``step``'s device."""
    step = step.to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    t = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree, shardings=None, mesh=None) -> torch.Tensor:
    """The L2 norm over every leaf.  On a mesh (``shardings``, the tree of
    :class:`~repro_torch.parallel.sharding.LeafSharding` of ``tree``'s
    leaves, and ``mesh``) each leaf's sum of squares is summed over its
    shards exactly once: the copies of a shard on ranks along axes its
    spec does not use enter as zeros, and one all-reduce over the mesh
    adds the shards."""
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    if mesh is not None:
        keep = [holds_first_copy(sh.spec, mesh) for sh in tree_leaves(shardings)]
        vec = torch.stack([x if k else torch.zeros_like(x) for x, k in zip(leaves, keep)])
        leaves = list(mesh.all_reduce_(vec, "sum").unbind(0))
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(f32_scalar(max_norm, norm) / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(tree, max_norm: float, shardings=None, mesh=None):
    norm = global_norm(tree, shardings, mesh)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda x: x.to(torch.float32) * scale, tree), norm


# ---------------------------------------------------------------------------
# int8 block-quantized moment storage
# ---------------------------------------------------------------------------

class Q8Layout:
    """How an int8 moment's blocks meet this rank's shard, where the shard
    cuts them: its last dim holds ``l`` columns from ``c0`` of the
    unsharded ``L``, and ``l`` is not a multiple of the block (256, or the
    whole ``L``), so a block spans ranks.  Its absmax is then the max over
    those ranks: each rank scatters its columns' maxima into all ``nb``
    blocks and one all-reduce (max) over the last dim's axes gives every
    block's; the scale leaf keeps its own shard of them (its spec
    replicates a block count the axes do not divide).  A shard that holds
    whole blocks needs none of this: :class:`Q8` quantizes it alone."""

    def __init__(self, param_sh, scale_sh, mesh):
        self.nb, self.bs = Q8._blocks(param_sh.shape)
        self.c0 = param_sh.start(mesh, -1)
        self.cols = param_sh.local_shape(mesh)[-1]
        self.axes = spec_axes(param_sh.spec[-1])
        self.scale_sh, self.mesh = scale_sh, mesh

    @staticmethod
    def cuts(param_sh, mesh) -> bool:
        if not param_sh.shape:
            return False
        _, bs = Q8._blocks(param_sh.shape)
        return param_sh.local_shape(mesh)[-1] % bs != 0

    def block_of_col(self, device) -> torch.Tensor:
        return torch.arange(self.c0, self.c0 + self.cols, device=device) // self.bs

    def full_scale(self, scale: torch.Tensor) -> torch.Tensor:
        """Every block's scale from this rank's shard of the scale leaf."""
        return self.mesh.all_gather_axes(scale, spec_axes(self.scale_sh.spec[-1]), -1)

    def local_scale(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the scale leaf from every block's scale."""
        idx, count = mesh_coord(self.mesh, spec_axes(self.scale_sh.spec[-1]))
        n = full.shape[-1] // count
        return full.narrow(-1, idx * n, n).contiguous()


def q8_layouts(shardings, mesh):
    """The tree of :class:`Q8Layout` (None where a shard holds whole
    blocks) over the parameters' leaves, from the train state's shardings
    (``sharding.train_state_shardings``); None off a mesh."""
    if mesh is None:
        return None

    def leaf(p_sh, m_sh):
        if isinstance(m_sh, Q8) and Q8Layout.cuts(p_sh, mesh):
            return Q8Layout(p_sh, m_sh.scale, mesh)
        return None
    return tree_map(leaf, shardings["params"], shardings["opt"]["m"])


class Q8:
    """Blockwise-absmax int8 tensor.

    ``q`` keeps the *parameter's own shape* (int8) and ``scale`` has the
    last dim replaced by the per-256-block count (one block of the whole
    last dim when 256 does not divide it).  On a mesh the blocks are
    those of the unsharded last dim: a shard that cuts them quantizes
    with a :class:`Q8Layout`.
    """

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q, self.scale = q, scale

    def replace(self, **kw) -> "Q8":
        return Q8(kw.get("q", self.q), kw.get("scale", self.scale))

    @staticmethod
    def _blocks(shape) -> Tuple[int, int]:
        last = shape[-1] if len(shape) else 1
        bs = _BLOCK if last % _BLOCK == 0 else last
        return max(last // bs, 1), bs

    @staticmethod
    def quantize(x: torch.Tensor, layout: Optional[Q8Layout] = None) -> "Q8":
        if layout is not None:
            return Q8._quantize_cut(x, layout)
        nb, bs = Q8._blocks(x.shape)
        xb = x.to(torch.float32).reshape(*x.shape[:-1], nb, bs)
        scale = torch.amax(torch.abs(xb), dim=-1) / 127.0
        q = torch.round(xb / torch.clamp(scale[..., None], min=1e-12))
        return Q8(q.reshape(x.shape).to(torch.int8), scale)

    @staticmethod
    def _quantize_cut(x: torch.Tensor, layout: Q8Layout) -> "Q8":
        a = torch.abs(x.to(torch.float32))
        blk = layout.block_of_col(x.device).expand(a.shape)
        part = torch.zeros(a.shape[:-1] + (layout.nb,), dtype=torch.float32, device=x.device)
        amax = layout.mesh.all_reduce_axes_(part.scatter_reduce_(-1, blk, a, "amax"),
                                            layout.axes, "max")
        scale = amax / 127.0
        q = torch.round(x.to(torch.float32)
                        / torch.gather(torch.clamp(scale, min=1e-12), -1, blk))
        return Q8(q.to(torch.int8), layout.local_scale(scale))

    def dequantize(self, layout: Optional[Q8Layout] = None) -> torch.Tensor:
        shape = self.q.shape
        if layout is not None:
            scale = layout.full_scale(self.scale)
            blk = layout.block_of_col(self.q.device).expand(shape)
            return self.q.to(torch.float32) * torch.gather(scale, -1, blk)
        nb, bs = Q8._blocks(shape)
        xb = self.q.to(torch.float32).reshape(*shape[:-1], nb, bs)
        return (xb * self.scale[..., None]).reshape(shape)

    def copy_(self, other: "Q8") -> "Q8":
        self.q.copy_(other.q)
        self.scale.copy_(other.scale)
        return self


def _rows(s, sl: slice):
    """Rows ``sl`` of the leading dim of a moment (a view: a ``Q8``'s
    values and its blocks' scales alike)."""
    return Q8(s.q[sl], s.scale[sl]) if isinstance(s, Q8) else s[sl]


def _store(x: torch.Tensor, dtype: str, layout=None):
    return Q8.quantize(x, layout) if dtype == "int8" else x


def _load(s, dtype: str, layout=None) -> torch.Tensor:
    return s.dequantize(layout) if dtype == "int8" else s


def adamw_init(params, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments (float32 or :class:`Q8`) beside every parameter leaf,
    on its device, and an int32 step of 0."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return _store(torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      cfg.moments_dtype)

    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig, *, shardings=None, mesh=None,
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """-> (new_params, new_state, metrics {"lr", "grad_norm"}).  The
    parameter and moment tensors are updated in place (module note).  On
    the training mesh (``shardings``, the train state's
    ``sharding.train_state_shardings``, and ``mesh``) every tensor is this
    rank's shard: the update is elementwise, the norm is global
    (:func:`global_norm`) and int8 moments keep the unsharded blocks
    (:class:`Q8Layout`)."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    grads = tree_map(lambda g: g.to(torch.float32), grads)
    p_sh = None if mesh is None else shardings["params"]
    gnorm = global_norm(grads, p_sh, mesh)
    # clip_by_global_norm's scale, applied leaf by leaf inside the update
    # (no second tree of gradients alive at once)
    scale = _clip_scale(gnorm, cfg.clip_norm) if cfg.clip_norm else None
    layouts = (q8_layouts(shardings, mesh) if cfg.moments_dtype == "int8" else None) \
        if mesh is not None else None

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1 - b1 ** stepf
    c2 = 1 - b2 ** stepf

    def upd(p, g, m_s, v_s, lay=None):
        if lay is None and p.ndim >= 2 and p.numel() > _UPDATE_ELEMS:
            rows = max(1, _UPDATE_ELEMS // (p.numel() // p.shape[0]))
            for i in range(0, p.shape[0], rows):
                sl = slice(i, i + rows)
                upd_slice(p[sl], g[sl], _rows(m_s, sl), _rows(v_s, sl))
            return p, m_s, v_s
        return upd_slice(p, g, m_s, v_s, lay)

    def upd_slice(p, g, m_s, v_s, lay=None):
        # m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g g, delta = (m / c1) /
        # (sqrt(v / c2) + eps) + wd p, p -= lr delta: the reference's ops
        # and order, each result written over a temporary of the same
        # rounding (float32 moments are updated in their own tensors), so
        # a few leaf-sized temporaries are alive at once, not eight
        if scale is not None:
            g = g * scale
        m = _load(m_s, cfg.moments_dtype, lay).mul_(b1).add_((1 - b1) * g)
        v = _load(v_s, cfg.moments_dtype, lay).mul_(b2).add_(((1 - b2) * g).mul_(g))
        den = torch.div(v, c2).sqrt_().add_(cfg.eps)
        delta = torch.div(m, c1).div_(den)
        del den
        delta.add_(cfg.weight_decay * p.to(torch.float32)).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_((p.to(torch.float32) - delta).to(p.dtype))
        del delta
        m_s.copy_(_store(m, cfg.moments_dtype, lay))
        v_s.copy_(_store(v, cfg.moments_dtype, lay))
        return p, m_s, v_s

    if layouts is None:
        out = tree_map(upd, params, grads, state["m"], state["v"])
    else:
        out = tree_map(upd, params, grads, state["m"], state["v"], layouts)

    def pick(i):
        return tree_map(lambda _p, o: o[i], params, out)

    new_state = {"step": step, "m": pick(1), "v": pick(2)}
    return pick(0), new_state, {"lr": lr, "grad_norm": gnorm}
