"""Closed-loop packed prefill of a mixture-of-experts model: the loop,
set-up, traffic parameters and stage-by-stage check of ``lm_prefill``,
with the MoE's own least work (``gpubench/work/moe.py``) and the
router's ties.

The configuration's keys must all be fields of the port's
``ModelConfig`` but for the descriptive ones (:data:`DESCRIPTIVE`):
``lm.model_config`` leaves an unknown key out, and a block switch that
the program does not know would run another block than the one the
reference checks.  A program without them fails here, before set-up.

Check: ``lm_prefill``'s numbers.  Where a token's last chosen and first
unchosen router probabilities lie within the reference's ``TIE_BAND``,
the reference gives a second output of the layer with those routings
swapped (``layer_both``), and each token row of the program's layer
output is held to the nearer of the two.  ``route_ties``, the tied rows
over the first recorded forward's layers, is printed on standard error
beside the numbers.

Faults (``FAULTS``, for ``calibrate.py`` and the tests), each the
published block's part left out of the program: ``renormalised`` (the
top-k probabilities renormalised), ``capacity`` (capacity factor 1.25,
so full experts drop tokens), ``ungated`` (the shared expert without its
gate), ``no_bias`` (q/k/v without their biases).
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Any, Dict

import torch

from gpubench import harness, lm
from gpubench.work import moe as moe_work

lm_prefill = harness.load_module("drivers", "lm_prefill")

# config keys that document the configuration and are no ModelConfig field
DESCRIPTIVE = ("source", "reduced", "assumed", "deployment")


def check_fields(cfg: Dict[str, Any]) -> None:
    """Raise where a config key is neither a ``ModelConfig`` field nor
    descriptive."""
    from repro_torch.models.common import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = sorted(set(cfg) - fields - set(DESCRIPTIVE))
    if unknown:
        raise RuntimeError(f"config keys the program's ModelConfig does not have: {unknown}")


def nearer(got: torch.Tensor, want: torch.Tensor, alt) -> torch.Tensor:
    """``want`` with each token row (the last dim's) replaced by ``alt``'s
    where that is nearer ``got``; ``want`` where there is no ``alt``."""
    if alt is None or got.shape != want.shape:
        return want
    g = got.to(want.device, torch.float32)
    far = (g - want.to(torch.float32)).norm(dim=-1) > (g - alt.to(torch.float32)).norm(dim=-1)
    return torch.where(far[..., None], alt, want)


class Run(lm_prefill.Run):
    def __init__(self, cell: harness.Cell, seed: int, device: torch.device):
        check_fields(cell.config)
        self.route_ties = 0
        super().__init__(cell, seed, device)

    def work(self) -> Dict[str, Any]:
        cfg = self.cell.config
        return {"step": moe_work.prefill_step_work(cfg, self.batch, self.length),
                "gemm": moe_work.prefill_kernel_work(cfg, self.batch, self.length)}

    def _numbers(self, float_dtype) -> Dict[str, Any]:
        cfg, ref, dev = self.cell.config, self.ref, self.device
        params = ref.make_params(cfg, self.seed, dev, lm.DTYPES[cfg["dtype"]])
        first = self.recorded[0]
        layers, alts, ties = [], [], 0
        for p, (x, _) in zip(ref.layer_params(params, cfg), first["layers"]):
            out, alt, n = ref.layer_both(p, x.to(dev), cfg, float_dtype)
            layers.append(out)
            alts.append(alt)
            ties += n
        if float_dtype == torch.float32:
            self.route_ties = ties
        return {"embed": ref.embed(params, self.tokens[first["j"]], cfg),
                "layers": layers, "alts": alts,
                "final": ref.final_logits(params, first["layers"][-1][1].to(dev), cfg,
                                          float_dtype),
                "head": [ref.head(params, r["head"].to(dev), cfg, float_dtype)
                         for r in self.recorded]}

    def _compare(self, got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, float]:
        layers = [nearer(g, w, a) for g, w, a in zip(got["layers"], want["layers"],
                                                      want["alts"])]
        return super()._compare(got, {**want, "layers": layers})

    def check(self) -> Dict[str, float]:
        out = super().check()
        first = self.recorded[0]["layers"]
        rows = sum(x.shape[0] * x.shape[1] for x, _ in first)
        print(f"route_ties {self.route_ties} of {rows} routed rows "
              f"(first recorded forward, every layer)", file=sys.stderr, flush=True)
        return out


@contextlib.contextmanager
def _overrides(**fields):
    """The program built with ``fields`` in its ModelConfig."""
    real = lm.model_config

    def model_config(cfg, **kw):
        return real(cfg, **{**kw, **fields})
    lm.model_config = model_config
    try:
        yield
    finally:
        lm.model_config = real


@contextlib.contextmanager
def _no_bias():
    """The packed tree without the q/k/v biases."""
    from repro_torch.models import packing

    real = packing.pack_lm_params

    def strip(tree):
        if isinstance(tree, dict):
            return {k: ({"w": v["w"]} if k in ("wq", "wk", "wv") else strip(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [strip(v) for v in tree]
        return tree

    packing.pack_lm_params = lambda params, *a, **kw: real(strip(params), *a, **kw)
    try:
        yield
    finally:
        packing.pack_lm_params = real


FAULTS = {"renormalised": lambda: _overrides(moe_renormalize=True),
          "capacity": lambda: _overrides(moe_dropless=False),
          "ungated": lambda: _overrides(shared_expert_gate=False),
          "no_bias": _no_bias}
