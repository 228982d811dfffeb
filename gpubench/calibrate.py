"""Readings that set a cell's limits: the program's numbers, the control's
and those of faults planted in the program, on many seeds in one process.

    python3 gpubench/calibrate.py --workload <cell> --seeds 1 2 3 --units 4 \
        [--control] [--faults half altered unchanged]

For each seed the cell's driver sets the program up, runs ``--units``
units of its traffic (no timing), records a unit as a run does after
its window, and frees the program's state; the
check then gives the program's numbers.  ``--control`` adds the
numbers of the reference put in the program's place at the precision
below the configuration's (the driver's ``control``).  ``--faults``
repeats a seed with a fault planted in the program (:func:`plant`: the
driver's own ``FAULTS``, else :data:`FAULTS`).  A cell on more than one
chip runs on as many cards, with the fault planted on every rank
(``gpubench/ranks.py``).  One JSON line per seed and reading.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time
from typing import Optional

ROOT = pathlib.Path(__file__).resolve().parent.parent
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from gpubench import harness, ranks  # noqa: E402


@contextlib.contextmanager
def _patched(obj, name: str, make):
    """``obj.name`` replaced by ``make(original)`` inside the block."""
    real = getattr(obj, name)
    setattr(obj, name, make(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


def _half_rows(out):
    """The first half of the rows' answers in place of the second's."""
    h = out.shape[0] // 2
    out = out.clone()
    out[h:2 * h] = out[:h]
    return out


def _altered(out):
    out = out.clone()
    out.view(-1)[0] += 1.0
    return out


def _stale(real):
    """A function that returns what ``real`` returned on the call before
    (a stale result; the first call's own)."""
    last = []

    def call(*args, **kw):
        out = real(*args, **kw)
        last.append(out)
        return last.pop(0) if len(last) > 1 else out
    return call


def _cnn(kind):
    """half: the second half of each batch's images left out (zeros, so
    the activation statistics are the rest's); altered: one logit off by
    one; image: one image's output of the second conv replaced by the
    next image's; channels: two output channels of the third conv
    swapped; stale: each call returns the previous call's logits."""
    from repro_torch.cnn import PaperCNN

    if kind in ("image", "channels"):
        def hook(module, args, y):
            y = y.clone()
            if kind == "image":
                i = y.shape[0] // 3
                y[i] = y[i + 1]
            else:
                y[..., [0, 1]] = y[..., [1, 0]]
            return y

        def make_init(real):
            def init(self, *args, **kw):
                real(self, *args, **kw)
                self.layers[1 if kind == "image" else 2].register_forward_hook(hook)
            return init
        return _patched(PaperCNN, "__init__", make_init)
    if kind == "stale":
        return _patched(PaperCNN, "forward", _stale)

    def make(real):
        def forward(self, x):
            if kind == "half":
                x = x.clone()
                x[x.shape[0] // 2:] = 0
                return real(self, x)
            return _altered(real(self, x))
        return forward
    return _patched(PaperCNN, "forward", make)


def _prefill(kind):
    """half: the second half of the prompts' logits replaced by the
    first's; altered: one logit off by one; stale: each forward returns
    the previous forward's logits."""
    from repro_torch.models import model

    if kind == "stale":
        return _patched(model, "prefill", _stale)
    fix = {"half": _half_rows, "altered": _altered}[kind]

    def make(real):
        def prefill(params, batch, caches, cfg, layout):
            logits, caches = real(params, batch, caches, cfg, layout)
            return fix(logits), caches
        return prefill
    return _patched(model, "prefill", make)


def _train(kind):
    """half: each step on the first half of its rows (the mean over
    those); altered: each step's loss 10% off; unchanged: the update
    leaves the parameters and moments as they were."""
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts

    if kind == "unchanged":
        def make(real):
            def update(grads, state, params, cfg, **kw):
                step = state["step"] + 1
                return params, {**state, "step": step}, {"lr": step * 0.0,
                                                         "grad_norm": adamw.global_norm(grads)}
            return update
        return _patched(adamw, "adamw_update", make)

    def make_step(real):
        def build(*args, **kw):
            step = real(*args, **kw)

            def run(state, batch):
                if kind == "half":
                    rows = batch["labels"].shape[0] // 2
                    return step(state, {k: v[:rows] for k, v in batch.items()})
                state, metrics = step(state, batch)
                return state, {**metrics, "loss": metrics["loss"] * 1.1}
            return run
        return build
    return _patched(ts, "make_train_step", make_step)


# driver -> fault name -> a context manager factory planting it
FAULTS = {"image_batches": _cnn, "lm_prefill": _prefill, "lm_train": _train}


def plant(cell: harness.Cell, kind: Optional[str]):
    """A context manager planting fault ``kind`` in the program for
    ``cell``: the driver module's own ``FAULTS[kind]()`` where it has one,
    else this module's table; none where ``kind`` is None."""
    if kind is None:
        return contextlib.nullcontext()
    driver = cell.traffic["driver"]
    own = getattr(harness.load_module("drivers", driver), "FAULTS", {})
    if kind in own:
        return own[kind]()
    return FAULTS[driver](kind)


def readings(cell: harness.Cell, seed: int, units: int, device, control: bool = False,
             fault: str = None) -> dict:
    """One seed's numbers: the program's (with ``fault`` planted on every
    rank), and the control's."""
    drv = harness.load_module("drivers", cell.traffic["driver"])
    t0 = time.perf_counter()
    with ranks.lead(cell, seed, device, fault) as lead:
        with plant(cell, fault):
            run = drv.Run(cell, seed, device)
            lead.built()
            first = getattr(run, "first_window_unit", lambda: 0)()
            for i in range(first, first + units):
                lead.call(run, "step", i)
            if hasattr(run, "record"):
                lead.call(run, "record")
        lead.call(run, "release")
        out = {"seed": seed, "fault": fault, "program": lead.call(run, "check")}
        if control:
            out["control"] = lead.call(run, "control")
        lead.end()
    out["s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--units", type=int, default=2)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="*", default=[])
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"calibrate: {args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        for fault in [None] + args.faults:
            print(json.dumps(readings(cell, seed, args.units, dev,
                                      control=args.control and fault is None, fault=fault)),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
