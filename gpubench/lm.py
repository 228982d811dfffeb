"""The program's language-model configuration from a cell's config file.

A language model's config file names its sizes by the fields of the
port's ``repro_torch.models.common.ModelConfig``; keys that are no such
field (``source``, ``reduced``, ``assumed``, ``deployment``) document
the configuration and are left out here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
from typing import Any, Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(cfg: Dict[str, Any], **overrides):
    """``ModelConfig`` of the config file ``cfg``, with ``overrides``."""
    from repro_torch.models.common import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields}
    kw["layer_pattern"] = tuple(tuple(entry) for entry in cfg["layer_pattern"])
    kw["dtype"] = DTYPES[cfg["dtype"]]
    kw.update(overrides)
    return ModelConfig(**kw)


class Recorder:
    """What a forward of the program hands from stage to stage, recorded
    while it runs inside :meth:`recording`: each layer's input and output
    (the first ``n_layers`` calls of the block in ``models.model``'s loop;
    a QAT step's remat recompute comes after them), the head's input,
    and, where autograd runs, the cotangent the backward hands each
    layer's output (``grads[i]``).  Every record is copied to the host,
    so that it takes no device memory while the program runs on.

    The check depends on these names of the program: ``block_forward``
    and ``logits_from_hidden``, looked up in ``repro_torch.models.model``
    by its layer loop and its heads at each call, and the block's output
    being the next block's input."""

    def __init__(self, n_layers: int):
        self.n_layers = n_layers
        self.layers = []
        self.grads = {}
        self.head = None

    @staticmethod
    def _keep(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu")

    def _hook(self, i: int, t: torch.Tensor) -> None:
        if t.requires_grad:
            t.register_hook(lambda g: self.grads.__setitem__(i, self._keep(g)))

    @contextlib.contextmanager
    def recording(self, layers: bool):
        from repro_torch.models import model

        real_block, real_head = model.block_forward, model.logits_from_hidden
        self.layers, self.grads, self.head = [], {}, None

        def block_forward(p, x, *args, **kw):
            out = real_block(p, x, *args, **kw)
            if layers and len(self.layers) < self.n_layers:
                self._hook(len(self.layers), out[0])
                self.layers.append((self._keep(x), self._keep(out[0])))
            return out

        def logits_from_hidden(params, x, cfg, layout):
            self.head = self._keep(x)
            return real_head(params, x, cfg, layout)

        model.block_forward, model.logits_from_hidden = block_forward, logits_from_hidden
        try:
            yield self
        finally:
            model.block_forward, model.logits_from_hidden = real_block, real_head


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want|; 1.0 where the shapes differ (rows left out)."""
    if got.shape != want.shape:
        return 1.0
    want = want.to(torch.float32)
    return float((got.to(want.device, torch.float32) - want).abs().max())


def layer_err(got, want, inputs) -> float:
    """The worst layer's ||got - want|| over the norm of what the reference's
    layer added to its input; 1.0 where a layer is missing or its shape
    differs."""
    if len(got) != len(want) or len(got) != len(inputs):
        return 1.0
    worst = 0.0
    for g, w, x in zip(got, want, inputs):
        if g is None or w is None or x is None or g.shape != w.shape:
            return 1.0
        g, x = g.to(w.device, torch.float32), x.to(w.device, torch.float32)
        w = w.to(torch.float32)
        worst = max(worst, float((g - w).norm() / (w - x).norm()))
    return worst


def rel_err(got, want) -> float:
    """||got - want|| / ||want||; 1.0 where either is missing or the shapes
    differ."""
    if got is None or want is None or got.shape != want.shape:
        return 1.0
    want = want.to(torch.float32)
    return float((got.to(want.device, torch.float32) - want).norm() / want.norm())


def leaf_err(got, want) -> float:
    """The worst leaf of the worst layer (``{layer: {leaf: gradient}}``):
    ||got - want|| over the larger of ||want|| and the layer's median leaf
    norm; 1.0 where a layer or leaf is missing."""
    if set(got) != set(want):
        return 1.0
    worst = 0.0
    for i, leaves in want.items():
        if set(got[i]) != set(leaves):
            return 1.0
        norms = {k: float(w.to(torch.float32).norm()) for k, w in leaves.items()}
        floor = statistics.median(norms.values())
        for k, w in leaves.items():
            g = got[i][k]
            if g.shape != w.shape:
                return 1.0
            diff = float((g.to(w.device, torch.float32) - w.to(torch.float32)).norm())
            worst = max(worst, diff / max(norms[k], floor))
    return worst


def logit_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over each row's standard deviation in the reference,
    the worst row; 1.0 where the shapes differ."""
    if got.shape != want.shape:
        return 1.0
    got, want = got.to(torch.float32).cpu(), want.to(torch.float32).cpu()
    return float(((got - want).abs().amax(dim=-1) / want.std(dim=-1)).max())
