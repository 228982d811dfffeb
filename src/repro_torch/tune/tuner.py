"""The measuring half of the autotuner: run each candidate blocking on
the device, keep the median time, return a :class:`~repro_torch.tune.
cache.Plan`.

Counterpart of ``repro/tune/tuner.py``.  Determinism contract:

* operands come from a seeded ``torch.Generator`` on the target device
  (the reference draws them with ``jax.random``), so every run measures
  the same bits;
* candidate order is deterministic (``TuningSpace.candidates``: the
  default first) and the winner is the argmin of the median times, ties
  to the earlier candidate;
* the JSON keeps only the decision, never the timings, so a re-run that
  reaches the same decision re-saves a byte-identical file, and a re-run
  against a warm cache measures nothing.

The tuner times the registered kernel entry (``KernelSpec.fn`` with an
explicit ``tiles=``), the code ``ops.qmm`` dispatches to.  On a CUDA
device each call is timed between two CUDA events, recorded around
back-to-back calls after the warm-up; on the CPU with
``time.perf_counter``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import registry
from repro_torch.kernels.modes import DEFAULT_DEVICE, QuantMode, resolve_device
from repro_torch.kernels.qtensor import QTensor
from repro_torch.tune import cache as plan_cache
from repro_torch.tune.space import TuningSpace

# NOTE: repro_torch.kernels.ops is imported inside the functions below:
# ops imports this package's cache at module scope.

__all__ = ["ConvProblem", "tune_one", "ensure_plan", "tune_shapes",
           "collect_problems", "measure"]

_ENSURE_CTR = obs.get_registry().counter(
    "repro_tune_ensure_total",
    "ensure_plan outcomes by result (hit | measured)",
    labels=("result",))
_MEASURE_HIST = obs.get_registry().histogram(
    "repro_tune_measure_seconds",
    "on-device candidate measurement latency per ensure_plan")


@dataclasses.dataclass(frozen=True)
class ConvProblem:
    """One implicit-im2col conv problem (registry layout
    ``im2col_fused``): the input extents plus the conv geometry; plans
    key on an extra ``geom`` tag."""
    batch: int
    height: int
    width: int
    cin: int
    cout: int
    kernel_h: int
    kernel_w: int
    stride: int = 1
    padding: str = "SAME"

    @classmethod
    def from_input(cls, x_shape, geometry, stride: int = 1,
                   padding: str = "SAME") -> "ConvProblem":
        b, h, w, _ = x_shape
        kh, kw, cin, cout = geometry
        return cls(batch=int(b), height=int(h), width=int(w), cin=int(cin),
                   cout=int(cout), kernel_h=int(kh), kernel_w=int(kw),
                   stride=int(stride), padding=str(padding))

    @property
    def geometry(self) -> Tuple[int, int, int, int]:
        return (self.kernel_h, self.kernel_w, self.cin, self.cout)

    @property
    def x_shape(self) -> Tuple[int, int, int, int]:
        return (self.batch, self.height, self.width, self.cin)

    def dims(self) -> Tuple[int, int, int, str]:
        """(m, n, k, geom_tag) of the implicit im2col GeMM."""
        from repro_torch.kernels import conv_fused

        return conv_fused.conv_problem_dims(self.x_shape, self.geometry,
                                            self.stride, self.padding)

    @property
    def kw_words(self) -> int:
        """Reduction words of the conv kernels: each patch position packs
        word-aligned."""
        return self.kernel_h * self.kernel_w * (-(-self.cin // 32))


def measure(call, *, warmup: int = 1, reps: int = 3,
            device: torch.device = torch.device("cpu")) -> float:
    """Median seconds of ``call()``.  On a CUDA device: CUDA events
    around each of ``reps`` back-to-back calls after ``warmup`` calls;
    on the CPU: ``time.perf_counter`` around each call."""
    for _ in range(max(1, warmup)):
        call()
    reps = max(1, reps)
    if device.type == "cuda":
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda.synchronize(device)
        for start, stop in events:
            start.record()
            call()
            stop.record()
        torch.cuda.synchronize(device)
        ts = [start.elapsed_time(stop) / 1e3 for start, stop in events]
    else:
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _make_problem(mode: QuantMode, m: int, n: int, k: int, seed: int,
                  device: torch.device):
    """Seeded packed operands for one (mode, m, n, k) problem on
    ``device``: (a_planes, b_planes, row_scale, col_scale, payload)."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=device)
    w = torch.randn((k, n), generator=gen, device=device)
    xa = ops.quantize_activations(x, mode)
    qt = ops.pack_weights(w, mode)
    a_planes = tuple(xa[key] for key in ops._A_KEYS[mode])
    return (a_planes, ops._b_planes(qt, mode), ops._as_row_scale(xa["scale"], m, x),
            ops._as_col_vec(qt.scale, n, x), qt.payload)


def _make_conv_problem(mode: QuantMode, conv: ConvProblem, seed: int,
                       device: torch.device):
    """Seeded operands for one conv problem on ``device``: (x, b_planes,
    stats, col_scale)."""
    from repro_torch.kernels import conv_fused, ops

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(conv.x_shape, generator=gen, device=device)
    kh, kw, cin, cout = conv.geometry
    w = torch.randn((kh * kw * cin, cout), generator=gen, device=device)
    qt = QTensor.from_dense(w, mode, geometry=conv.geometry)
    stats = conv_fused.conv_act_stats(x, mode, kh, kw, conv.stride, conv.padding)
    return (x, conv_fused.conv_weight_planes(qt), stats,
            ops._as_col_vec(qt.scale, cout, x))


def tune_one(mode: QuantMode, backend: str, *, fused: bool = True,
             m: Optional[int] = None, n: Optional[int] = None, k: Optional[int] = None,
             space: Optional[TuningSpace] = None, reps: int = 3, warmup: int = 1,
             seed: int = 0, conv: Optional[ConvProblem] = None,
             device=DEFAULT_DEVICE) -> Tuple[plan_cache.Plan, Dict]:
    """Measure every candidate blocking for one problem on ``device`` and
    return the winning :class:`Plan` plus a per-candidate report.

    GeMM problems are measured at their m-bucket (the plan's
    granularity); ``conv`` tunes the implicit-im2col cell at the exact
    input extents instead (m/n/k derived).  A cell with no space (the
    conv kernels' tiles are compiled in) keeps its default plan."""
    dev = resolve_device(device)
    layout = registry.LAYOUT_GEMM
    geom = None
    if conv is not None:
        if not (m is None and n is None and k is None):
            raise ValueError("pass either conv= or explicit m/n/k, not both")
        m, n, k, geom = conv.dims()
        layout = registry.LAYOUT_IM2COL
    if m is None or n is None or k is None:
        raise ValueError("tune_one needs m, n, k (or a conv problem)")
    spec = registry.lookup(mode, backend, fused=fused, layout=layout)
    space = space if space is not None else spec.tunable
    mb = m if conv is not None else plan_cache.bucket_m(m)
    default = plan_cache.default_plan(mode, backend, fused, mb, n, k, layout=layout,
                                      geom=geom, device=dev)
    if space is None:
        return default, {"candidates": [], "best_index": -1, "untunable": True}
    cands = space.candidates(mb, n, k, default=default.tiles,
                             kw=None if conv is None else conv.kw_words)
    if conv is not None:
        x, b_pl, stats, col = _make_conv_problem(mode, conv, seed, dev)
    else:
        a_pl, b_pl, row, col, payload = _make_problem(mode, mb, n, k, seed, dev)
        extra = {"payload": payload} if spec.payload_aware else {}

    times: List[float] = []
    with torch.no_grad():
        for tc in cands:
            if conv is not None:
                def call(tc=tc):
                    return spec.fn(x, b_pl, conv.geometry, conv.stride, conv.padding,
                                   stats, col, None, tiles=tc)
            elif fused:
                def call(tc=tc):
                    return spec.fn(a_pl, b_pl, k, row, col, None, tiles=tc, **extra)
            else:
                def call(tc=tc):
                    return spec.fn(a_pl, b_pl, k, tiles=tc, **extra)
            times.append(measure(call, warmup=warmup, reps=reps, device=dev))

    best = int(np.argmin(times))          # ties -> earliest candidate
    plan = dataclasses.replace(default, m_bucket=plan_cache.bucket_m(m),
                               tiles=cands[best], source="tuned")
    report = {"candidates": [{"tiles": tc.to_json(), "median_s": t}
                             for tc, t in zip(cands, times)],
              "best_index": best, "default_s": times[0], "best_s": times[best]}
    return plan, report


def ensure_plan(mode: QuantMode, backend: str, *, fused: bool = True,
                m: Optional[int] = None, n: Optional[int] = None, k: Optional[int] = None,
                reps: int = 3, warmup: int = 1, seed: int = 0, save: bool = True,
                reports: Optional[Dict[str, Dict]] = None,
                conv: Optional[ConvProblem] = None,
                device=DEFAULT_DEVICE) -> Tuple[plan_cache.Plan, bool]:
    """Cache-or-measure: ``(plan, measured)``.  A warm cache is a dict
    lookup (what ``ops.qmm`` calls per request under "on_first_use").
    ``reports`` collects the timing table of every measurement made, by
    plan key.  Past argument validation nothing here propagates: a
    broken cache, a failed measurement or a failed save resolve to the
    default plan (containment)."""
    dev = resolve_device(device)
    layout = registry.LAYOUT_GEMM
    geom = None
    if conv is not None:
        m, n, k, geom = conv.dims()
        layout = registry.LAYOUT_IM2COL
    if m is None or n is None or k is None:
        raise ValueError("ensure_plan needs m, n, k (or a conv= problem)")
    try:
        cache = plan_cache.get_cache()
        key = plan_cache.plan_key(mode, backend, fused, plan_cache.device_kind(dev),
                                  plan_cache.bucket_m(m), n, k, layout=layout, geom=geom)
        hit = cache.get(key)
        if hit is not None:
            _ENSURE_CTR.inc(result="hit")
            return hit, False
        _ENSURE_CTR.inc(result="measured")
        with _MEASURE_HIST.time():
            if conv is not None:
                plan, report = tune_one(mode, backend, fused=fused, conv=conv, reps=reps,
                                        warmup=warmup, seed=seed, device=dev)
            else:
                plan, report = tune_one(mode, backend, fused=fused, m=m, n=n, k=k,
                                        reps=reps, warmup=warmup, seed=seed, device=dev)
        if reports is not None:
            reports[plan.key] = report
        cache.put(plan)
    except Exception as e:
        plan_cache.contained("ensure_plan", e)
        return plan_cache.plan_for(mode, backend, fused=fused, m=m, n=n, k=k,
                                   layout=layout, geom=geom, device=dev), False
    if save:
        try:
            cache.save()
        except Exception as e:
            # the plan is live in memory either way
            plan_cache.contained("save", e)
    return plan, True


def tune_shapes(shapes: Iterable[Tuple[int, int, int]], modes: Sequence[QuantMode],
                backends: Sequence[str], *, fused: bool = True, reps: int = 3,
                warmup: int = 1, seed: int = 0, verbose: bool = False,
                conv_problems: Sequence[ConvProblem] = (), device=DEFAULT_DEVICE,
                ) -> Tuple[List[plan_cache.Plan], Dict[str, int], Dict[str, Dict]]:
    """Offline sweep: a plan for every (shape x mode x backend) with a
    tunable registered kernel, GeMM shapes and conv geometries.  Returns
    ``(plans, {"measured", "cached", "skipped"}, reports)``; a second
    run over a warm cache reports ``measured == 0``."""
    dev = resolve_device(device)
    plans: List[plan_cache.Plan] = []
    stats = {"measured": 0, "cached": 0, "skipped": 0}
    reports: Dict[str, Dict] = {}

    def one(mode, backend, layout, **kw):
        if not registry.has(mode, backend, fused=fused, layout=layout) or \
                registry.lookup(mode, backend, fused=fused, layout=layout).tunable is None:
            stats["skipped"] += 1
            return
        plan, measured = ensure_plan(mode, backend, fused=fused, reps=reps, warmup=warmup,
                                     seed=seed, save=False, reports=reports, device=dev,
                                     **kw)
        stats["measured" if measured else "cached"] += 1
        plans.append(plan)
        if verbose:
            src = "measured" if measured else "cache-hit"
            print(f"  {plan.key:<46s} -> {plan.tiles.to_json()}  [{src}]")

    from repro_torch.kernels import ops  # noqa: F401  (registers the cells)

    for (m, n, k) in shapes:
        for mode in modes:
            for backend in backends:
                one(mode, backend, registry.LAYOUT_GEMM, m=m, n=n, k=k)
    for prob in conv_problems:
        for mode in modes:
            for backend in backends:
                one(mode, backend, registry.LAYOUT_IM2COL, conv=prob)
    try:
        plan_cache.get_cache().save()
    except Exception as e:
        plan_cache.contained("save", e)
    return plans, stats, reports


def collect_problems(params) -> List[Tuple]:
    """Every distinct packed low-bit problem ``(mode, k, n, geometry)`` of
    a parameter tree (dicts and lists), in walk order — what the serving
    engine tunes at build.  A stacked container (``QTensor.stack``, the
    (P, E) expert containers) keeps its logical (k, n), so it counts as
    its per-period problem."""
    seen: List[Tuple] = []

    def walk(tree):
        if isinstance(tree, QTensor):
            if tree.is_lowbit:
                prob = (tree.mode, tree.k_valid, tree.out_features, tree.geometry)
                if prob not in seen:
                    seen.append(prob)
        elif isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)

    walk(params)
    return seen
