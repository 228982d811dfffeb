"""``meta`` stand-ins and shardings for every dry-run cell.

Counterpart of ``repro/launch/specs.py``.  ``cell_artifacts(cfg, shape)``
(called inside ``sharding.use_mesh``, on a real or a
:class:`~repro_torch.launch.mesh.PlaceholderMesh`) returns what
``launch/dryrun.py`` runs for one (architecture x input shape) cell:

    step_fn  the function the cell runs (the train step / ``prefill`` /
             the serve step, by the shape's kind)
    args     its arguments: ``meta`` tensors (no memory, ever) at the
             shapes one rank of the port holds
    specs    per argument, ``{leaf path: spec tuple}`` of the whole
             shapes (``sharding.spec_for`` / ``param_spec``, the
             reference's ``in_shardings``; the train state's from
             ``sharding.train_state_shardings``; paths as
             ``tree.flatten_with_paths`` writes them)
    donate   argnums the step updates in place (the reference's donation)

What one rank holds follows the port's meshes, not the reference's
GSPMD: the training mesh keeps each rank's shard of every leaf
(``LeafSharding.local_shape``) and its rows of the global batch
(``data.pipeline.mesh_rows`` over ``sharding.batch_axes``), and a dense
config's step splits heads, FFN, vocab and the sequence over "model"
(``train/train_step.py``; the layout from ``models.common.train_layout``);
the serving mesh keeps each rank's slice of the packed bit planes
(``pack_lm_params`` under the mesh) while float leaves, caches and
activations stay whole on every rank.  Train cells run the production step (forward,
backward, chunked loss, AdamW with int8 moments, microbatches by
:func:`default_train_config`); decode cells one token against a
seq_len-deep cache on the packed tree; prefill cells the prompt into the
caches.  Random draws come from a CPU ``torch.Generator``: ``meta`` has
none of its own.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import mesh_rows
from repro_torch.models import model as model_mod
from repro_torch.models.common import ModelConfig, ShardLayout, train_layout
from repro_torch.models.kvcache import cache_logical_axes, init_caches
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import sharding
from repro_torch.serving.engine import make_serve_step, make_serve_step_embeddings
from repro_torch.train.train_step import (TrainStepConfig, init_train_state, make_train_step,
                                          state_shardings)

__all__ = ["CellArtifacts", "cell_artifacts", "make_layout", "default_train_config"]

META = torch.device("meta")


@dataclasses.dataclass
class CellArtifacts:
    step_fn: Any
    args: Tuple[Any, ...]
    specs: Tuple[Any, ...]
    donate: Tuple[int, ...]
    kind: str


def make_layout() -> ShardLayout:
    ctx = sharding.active()
    tp = ctx.axis_sizes.get("model", 1) if ctx else 1
    return ShardLayout(tp=tp)


def default_train_config(cfg: ModelConfig) -> TrainStepConfig:
    """The reference's production defaults: int8 moments, EF compression
    off, microbatches by model size (8 above 100B parameters, 4 above
    20B, 2 above 5B, else 1; ``REPRO_MICROBATCH`` overrides)."""
    total = cfg.param_counts()["total"]
    micro = 8 if total > 100e9 else 4 if total > 20e9 else 2 if total > 5e9 else 1
    if os.environ.get("REPRO_MICROBATCH"):
        micro = int(os.environ["REPRO_MICROBATCH"])
    return TrainStepConfig(optimizer=AdamWConfig(moments_dtype="int8"),
                           ef_compression=False, microbatch=micro)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _specs(t) -> Dict[str, Any]:
    """``{path: param_spec}`` of every leaf of a whole-shape tree."""
    return {path: sharding.param_spec(path, leaf) for path, leaf in tree.flatten_with_paths(t)}


def _batch(cfg: ModelConfig, b: int, s: int, *, with_labels: bool) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if cfg.input_kind == "embeddings":
        out["embeddings"] = _meta((b, s, cfg.d_model), torch.bfloat16)
    else:
        out["tokens"] = _meta((b, s), torch.int32)
    if with_labels:
        out["labels"] = _meta((b, s), torch.int32)
        out["mask"] = _meta((b, s), torch.float32)
    return out


def _batch_specs(batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    return {k: sharding.spec_for(v.shape, ("batch", "seq", None) if v.ndim == 3
                                 else ("batch", "seq"))
            for k, v in batch.items()}


class _NoMesh:
    """Suspend the active mesh (whole-shape trees are built outside it)."""

    def __enter__(self):
        self._tok = sharding._ACTIVE.set(None)

    def __exit__(self, *exc):
        sharding._ACTIVE.reset(self._tok)


def _serve_params(cfg: ModelConfig, layout: ShardLayout):
    """(one rank's inference tree, the whole tree's specs): bf16 leaves,
    the low-bit projections offline-PACKED (the paper's Algorithm 2), as
    the reference's decode cells lower against.  Under a mesh each packed
    container holds this rank's plane slice."""
    from repro_torch.models.packing import pack_lm_params

    pol = cfg.policy
    lowbit = any(pol.for_class(c).is_lowbit for c in ("attn_proj", "ffn_proj", "ssm_proj"))

    def build():
        p = model_mod.init_lm(torch.Generator(), cfg, layout, dtype=torch.bfloat16,
                              device=META)
        return pack_lm_params(p, cfg, pol) if lowbit else p

    with _NoMesh():
        whole = build()
    specs = _specs(whole)
    local = build() if lowbit and sharding.active() is not None else whole
    return local, specs


def _caches(cfg: ModelConfig, layout: ShardLayout, b: int, s: int):
    caches = init_caches(cfg, layout, b, s, device=META)
    axes = cache_logical_axes(cfg)
    specs = {f"{i}/{k}": sharding.spec_for(entry[k].shape, ax[k])
             for i, (entry, ax) in enumerate(zip(caches, axes)) for k in sorted(entry)}
    return caches, specs


def _local_rows(global_batch: int, micro: int) -> int:
    ctx = sharding.active()
    if ctx is None:
        return global_batch
    idx, count = sharding.mesh_coord(ctx.mesh, sharding.batch_axes(ctx))
    return len(mesh_rows(global_batch, idx, count, micro))


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _train_cell(cfg: ModelConfig, shape: ShapeSpec,
                tcfg: Optional[TrainStepConfig]) -> CellArtifacts:
    # tp: the size of the axis the step splits heads, FFN and vocab over
    layout = train_layout()
    tcfg = tcfg or default_train_config(cfg)
    step = make_train_step(cfg, layout, tcfg)
    gen = torch.Generator()
    if sharding.active() is None:
        state = init_train_state(gen, cfg, layout, tcfg, device=META)
        specs = {path: (None,) * t.ndim for path, t in tree.flatten_with_paths(state)}
    else:
        sh = state_shardings(cfg, layout, tcfg)
        state = init_train_state(gen, cfg, layout, tcfg, device=META, shardings=sh)
        specs = {path: leaf.spec for path, leaf in tree.flatten_with_paths(sh)}
    b, s = shape.global_batch, shape.seq_len
    # the step's shardings come from a whole-shape meta skeleton: built
    # here, so the cell's count of live bytes holds the step's alone
    step.prepare(sharding.active(), s)
    whole = _batch(cfg, b, s, with_labels=True)
    batch = _batch(cfg, _local_rows(b, tcfg.microbatch), s, with_labels=True)
    return CellArtifacts(step_fn=step, args=(state, batch), specs=(specs, _batch_specs(whole)),
                         donate=(0,), kind="train")


def _prefill_cell(cfg: ModelConfig, shape: ShapeSpec) -> CellArtifacts:
    layout = make_layout()
    b, s = shape.global_batch, shape.seq_len

    def prefill_fn(params, caches, batch):
        return model_mod.prefill(params, batch, caches, cfg, layout)

    params, p_specs = _serve_params(cfg, layout)
    caches, c_specs = _caches(cfg, layout, b, s)
    batch = _batch(cfg, b, s, with_labels=False)
    return CellArtifacts(step_fn=prefill_fn, args=(params, caches, batch),
                         specs=(p_specs, c_specs, _batch_specs(batch)), donate=(1,),
                         kind="prefill")


def _decode_cell(cfg: ModelConfig, shape: ShapeSpec) -> CellArtifacts:
    layout = make_layout()
    b, s = shape.global_batch, shape.seq_len
    serve = (make_serve_step_embeddings(cfg, layout) if cfg.input_kind == "embeddings"
             else make_serve_step(cfg, layout))
    params, p_specs = _serve_params(cfg, layout)
    caches, c_specs = _caches(cfg, layout, b, s)
    if cfg.input_kind == "embeddings":
        tok = _meta((b, 1, cfg.d_model), torch.bfloat16)
        tok_spec = sharding.spec_for(tok.shape, ("batch", None, None))
    else:
        tok = _meta((b, 1), torch.int32)
        tok_spec = sharding.spec_for(tok.shape, ("batch", None))
    step = _meta((b,), torch.int32)
    return CellArtifacts(step_fn=serve, args=(params, caches, tok, step, torch.Generator()),
                         specs=(p_specs, c_specs, tok_spec,
                                sharding.spec_for((b,), ("batch",)), ()),
                         donate=(1,), kind="decode")


def cell_artifacts(cfg: ModelConfig, shape: ShapeSpec,
                   tcfg: Optional[TrainStepConfig] = None) -> CellArtifacts:
    """The artifacts of one cell, on the active mesh (inside
    ``sharding.use_mesh``; without one, a single device's)."""
    if shape.kind == "train":
        return _train_cell(cfg, shape, tcfg)
    if shape.kind == "prefill":
        return _prefill_cell(cfg, shape)
    if shape.kind == "decode":
        return _decode_cell(cfg, shape)
    raise ValueError(shape.kind)
