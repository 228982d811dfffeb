"""A toy kind of traffic: one all-reduce a unit over every rank of the cell.

Traffic parameters: a ``pool`` of integer-valued float32 vectors of the
configuration's ``elements`` on each rank, made from the seed on the
device; ``warmup`` units in set-up; ``profile_units`` units in the traced
stretch; ``ballast_mib``: rank r holds (r + 1) times that many MiB more,
so that the ranks' peaks differ.  A unit: copy a pool vector into the
buffer, all-reduce it over the ranks (:func:`_exchange`), read its
float64 sum to the host.  For the harness's tests: ``raise_at`` [rank,
unit] makes that rank raise at that unit, ``stall_at`` [rank, unit]
makes it sleep there for an hour; ``call_log``, a directory, where each
rank writes the calls it made, at its check.

A cell on more than one chip joins the world through the program's
entry (``repro_torch.launch.mesh.init_rank``) and leaves it at
``release``.

Check (rank 0): ``sum_err``, the largest gap between a unit's sum and
the reference's sum of that pool entry over every rank (exact: small
integers).  Fault ``dropped`` leaves the exchange out on every rank.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import time
from typing import Any, Dict, List

import torch

from gpubench import harness


def _exchange(x: torch.Tensor) -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.all_reduce(x)


@contextlib.contextmanager
def _dropped():
    real = globals()["_exchange"]
    globals()["_exchange"] = lambda x: None
    try:
        yield
    finally:
        globals()["_exchange"] = real


FAULTS = {"dropped": _dropped}


class Run:
    def __init__(self, cell: harness.Cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        cfg, tr = cell.config, cell.traffic
        self.ref = harness.load_module("reference", cfg["name"])
        self.rank, self.world = 0, 1
        if cell.chips > 1:
            import torch.distributed as dist
            from repro_torch.launch import mesh

            mesh.init_rank(device=device.type)
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.calls: List[list] = []
        self.inputs = self.ref.make_inputs(cfg, seed, self.rank, tr["pool"], device)
        self.buf = torch.empty_like(self.inputs[0])
        self.ballast = torch.empty((self.rank + 1) * tr["ballast_mib"] * 2**20,
                                   dtype=torch.uint8, device=device)
        self.sums: List[tuple] = []
        for i in range(tr["warmup"]):
            self.step(i)
        self.sums.clear()

    def step(self, i: int) -> None:
        self.calls.append(["step", i])
        if self.cell.traffic.get("raise_at") == [self.rank, i]:
            raise RuntimeError(f"toy fault on rank {self.rank} at unit {i}")
        if self.cell.traffic.get("stall_at") == [self.rank, i]:
            time.sleep(3600)
        j = i % self.inputs.shape[0]
        with torch.profiler.record_function("gpubench.toy.unit"):
            self.buf.copy_(self.inputs[j])
            _exchange(self.buf)
            self.sums.append((j, float(self.buf.sum(dtype=torch.float64))))

    def first_window_unit(self) -> int:
        return self.cell.traffic["warmup"]

    def units_for_trace(self) -> int:
        return self.cell.traffic["profile_units"]

    def end_to_end(self, window: harness.Window) -> Dict[str, Any]:
        return {"toy_units_per_s": (window.done / window.seconds, "units/s")}

    def work(self) -> Dict[str, Any]:
        return {}

    def release(self) -> None:
        self.calls.append(["release"])
        self.inputs = self.buf = self.ballast = None
        if self.world > 1:
            from repro_torch.launch import mesh

            mesh.shutdown()

    def check(self) -> Dict[str, float]:
        self.calls.append(["check"])
        log = self.cell.traffic.get("call_log")
        if log:
            (pathlib.Path(log) / f"rank{self.rank}.json").write_text(json.dumps(self.calls))
        if self.rank != 0:
            return {}
        tr = self.cell.traffic
        want = self.ref.sums(self.cell.config, self.seed, self.world, tr["pool"], self.device)
        if not self.sums:
            return {"sum_err": 1.0}
        return {"sum_err": max(abs(got - want[j]) for j, got in self.sums)}
