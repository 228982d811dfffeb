"""What every cell shares: finding a cell's files by the names in
``BENCHMARK.json``, the closed loop over the measured window, the
profiled stretch and its reading, and the result line.

Nothing here imports the program.  A cell is ``workloads[i]`` of
``BENCHMARK.json``; its files:

* ``configs/<config>.json``: the configuration's sizes, as run;
* ``reference/<config>.py``: its plain reference (and the weights and
  inputs the benchmark makes for both sides);
* ``traffic/<traffic>.json``: the traffic mix, whose ``driver`` names
  ``drivers/<driver>.py``, the loop that sets the program up, drives it
  and checks it;
* ``limits/<cell>.json``: the limit of each number the check compares;
* ``metrics/<metric>.py`` (or ``metrics/<prefix>.py`` for
  ``<prefix>.<suffix>``): the reader of a per-layer metric.

A cell on more than one chip runs on as many ranks (``ranks.py``).
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import json
import os
import pathlib
import sys
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names the benchmark's process may not hold once the
# window has closed (the JAX package and JAX itself)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

__all__ = ["HERE", "ROOT", "FORBIDDEN", "set_cache_dirs", "load_json", "Cell", "find_cell",
           "load_module", "closed_loop", "Window", "Trace", "profiler", "read_profile",
           "profile", "breakdown", "forbidden_modules", "percentile", "device_info",
           "metric_reader", "is_port_kernel", "is_float_gemm"]


def set_cache_dirs() -> None:
    """Point every build and plan cache the program may use at fixed
    directories inside this checkout (the kernels build into
    ``build/kernels`` there by themselves)."""
    cache = ROOT / "build" / "gpubench"
    os.environ["REPRO_TUNE_CACHE"] = str(cache / "tune_plans.json")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def load_json(rel: str) -> Dict[str, Any]:
    return json.loads((HERE / rel).read_text())


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    chips: int
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read and the
    metrics it reports."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_file = pathlib.Path(configs[w["config"]]["file"])
    config = json.loads((ROOT / cfg_file).read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)
                 and ("workloads" in m or any(e["name"] == m["moves"] for e in e2e))]
    return Cell(name=name, config=config, traffic=load_json(f"traffic/{w['traffic']}.json"),
                limits=load_json(f"limits/{name}.json"), chips=int(w["chips"]),
                end_to_end=e2e, per_layer=per_layer)


def load_module(kind: str, name: str):
    """``gpubench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    mod_name = f"gpubench_{kind}_{name.replace('.', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, else
    ``metrics/<prefix>.py`` for a name ``<prefix>.<suffix>``."""
    if (HERE / "metrics" / f"{name}.py").exists():
        return load_module("metrics", name)
    return load_module("metrics", name.split(".")[0])


# ---------------------------------------------------------------------------
# The measured window
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Window:
    """A closed loop's record: units completed, the seconds from the
    window's start to the end of the last one, and each unit's latency."""
    done: int
    seconds: float
    latencies: List[float]

    @property
    def per_unit_s(self) -> float:
        return self.seconds / self.done


def closed_loop(step: Callable[[int], None], seconds: float, first: int = 0) -> Window:
    """Call ``step(first + i)`` for i = 0, 1, ... one after another (each
    returns when its work is done) until ``seconds`` have passed since the
    start; the window ends with the last unit."""
    lat: List[float] = []
    start = time.perf_counter()
    end = start
    i = 0
    while end - start < seconds:
        t = time.perf_counter()
        step(first + i)
        end = time.perf_counter()
        lat.append(end - t)
        i += 1
    return Window(done=i, seconds=end - start, latencies=lat)


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile, linear between the order statistics."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


# ---------------------------------------------------------------------------
# The profiled stretch
# ---------------------------------------------------------------------------

_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")
# the port's hand-written kernels (``src/repro_torch/kernels/csrc``)
PORT_KERNELS = ("lowbit_gemm_kernel", "conv_pack_kernel", "lowbit_conv_kernel",
                "dense_gemm_kernel", "dense_conv_kernel", "affine_gemm_kernel")


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


def is_float_gemm(name: str) -> bool:
    """A library (cuBLAS / CUTLASS) matrix product."""
    low = name.lower()
    return not is_port_kernel(name) and any(k in low for k in ("gemm", "xmma", "cutlass"))


@dataclasses.dataclass
class Trace:
    """What a per-layer reader reads: the profiled stretch's device
    operations (name, start s, end s; kernels and copies), the host spans
    around them, the number of units profiled, the unprofiled seconds per
    unit from the window, the cell's work from shapes and its memory."""
    units: int
    unit_wall_s: float
    device_ops: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]
    window_s: float
    work: Dict[str, Any]
    peak_bytes: int

    @property
    def kernels(self) -> List[Tuple[str, float, float]]:
        return [op for op in self.device_ops if not op[0].startswith(_NOT_KERNELS)]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, merged, in order."""
        out: List[List[float]] = []
        for _, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_s(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for name, s, e in self.kernels if match(name))


def profiler():
    """A ``torch.profiler`` session with CPU and CUDA activities."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    return torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def read_profile(prof, units: int, unit_wall_s: float, window_s: float,
                 work: Dict[str, Any], peak_bytes: int) -> Trace:
    """The Trace of a finished :func:`profiler` session over ``units``
    units."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        span = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            # a host span's range on the device timeline is no operation
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith(
                    "gpubench."):
                dev.append(span)
        elif e.device_type == DeviceType.CPU:
            host.append(span)
    return Trace(units=units, unit_wall_s=unit_wall_s, device_ops=dev, host_ops=host,
                 window_s=window_s, work=work, peak_bytes=peak_bytes)


def profile(run_units: Callable[[], None], units: int, unit_wall_s: float,
            work: Dict[str, Any], peak_bytes: int) -> Trace:
    """Run ``run_units()`` (``units`` units of the cell's work) under
    :func:`profiler` and read its events."""
    import torch

    torch.cuda.synchronize()
    with profiler() as prof:
        t0 = time.perf_counter()
        run_units()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return read_profile(prof, units, unit_wall_s, window_s, work, peak_bytes)


def _host_namer(trace: Trace) -> Callable[[float], str]:
    """A function of a time: the innermost host span open then (the one
    that began last), under the outermost benchmark span open then."""
    ops = sorted(trace.host_ops, key=lambda h: h[1])
    starts = [h[1] for h in ops]
    outer = [h for h in ops if h[0].startswith("gpubench.")]

    def name(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and ops[i][2] < t:
            i -= 1
        inner = ops[i][0] if i >= 0 else "(no host span)"
        out = [h[0] for h in outer if h[1] <= t <= h[2]]
        return f"{out[0]}/{inner}" if out and out[0] != inner else inner
    return name


def breakdown(trace: Trace, top: int = 10, named: int = 400) -> Dict[str, List[List[Any]]]:
    """The device operations that took most time, and the idle gaps between
    them summed by what the host was doing when each began (the ``named``
    longest gaps; the rest together), in seconds over the profiled
    stretch."""
    by_op: Dict[str, float] = {}
    for name, s, e in trace.device_ops:
        by_op[name[:160]] = by_op.get(name[:160], 0.0) + (e - s)
    busy = trace.busy_intervals()
    all_gaps = sorted(((s1 - e0, e0) for (_, e0), (s1, _) in zip(busy, busy[1:])),
                      reverse=True)
    namer = _host_namer(trace)
    gaps: Dict[str, float] = {}
    for length, t in all_gaps[:named]:
        what = namer(t)[:160]
        gaps[what] = gaps.get(what, 0.0) + length
    if len(all_gaps) > named:
        gaps["(shorter gaps)"] = sum(g for g, _ in all_gaps[named:])
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


# ---------------------------------------------------------------------------
# The result
# ---------------------------------------------------------------------------

def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is one of
    ``FORBIDDEN``, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def device_info(torch, device, count: int, peaks: Sequence[int] = ()) -> Dict[str, Any]:
    """The result's ``device``: ``memory_peak_bytes`` is the fullest rank's
    peak (this process's, and ``peaks`` from the other ranks)."""
    own = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    by_rank = [own] + [int(p) for p in peaks]
    if device.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count}
    else:
        out = {"platform": device.type, "kind": device.type, "count": count}
    return {**out, "memory_peak_bytes": max(by_rank), "memory_peak_bytes_by_rank": by_rank}
