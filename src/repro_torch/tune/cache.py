"""Persistent autotuning plan cache.

Counterpart of ``repro/tune/cache.py``.  Plans map one *problem* —
``(mode, backend, fused, device_kind, m-bucket, n, k)`` — to the
:class:`TileConfig` the tuner selected for it.  They persist as one JSON
file, so offline sweeps (``python -m repro_torch.tune``,
``ServeConfig(autotune="offline")``) survive process restarts.

Design points (the reference's):

* **m-bucketing** — the m axis is bucketed to the next power of two
  (min 8); n and k identify the packed weight exactly;
* **atomic writes** — a same-directory temp file, fsync, ``os.replace``;
  writers serialize on an ``fcntl`` lock on ``<path>.lock`` and merge the
  file on disk under it, so two processes union their plans;
* **canonical serialization** — sorted keys, fixed indentation, no
  timings: re-saving an unchanged cache is byte-identical;
* **deterministic fallback** — a miss, or a corrupt or missing file,
  gives the default plan; a failure anywhere in the tune plane is
  *contained* (counted, logged, warned) and never reaches the kernel.

What differs in the port:

* ``device_kind()`` is the sanitized ``torch.cuda.get_device_name()``
  of the device (e.g. ``nvidia-h100-80gb-hbm3``), or ``"cpu"``;
* the default plan of a CUDA GeMM cell is ``gemm_tile``'s CTA tile for
  the shape on that card (the reference's is ``DEFAULT_TILES``); on the
  CPU, where no kernel runs, its ``cta_tile`` is None (``gemm_tile``'s
  choice at launch);
* ``plan_for`` runs on every ``qmm`` request, so a resolved plan is
  memoized per problem on the cache object and the memo dropped
  whenever the table changes (``put``, ``load``): a repeated request is
  one dict lookup.  This is the counterpart of the reference's "the
  plan is part of the jit cache key".

The cache path resolves from ``REPRO_TUNE_CACHE``, else
``~/.cache/repro_torch/tune_plans.json`` — not the reference's default
file: the two packages' plan keys can coincide (the "dense" and
"indexed" backends, the "cpu" device) while their tiles differ.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import re
import tempfile
import time
import warnings
from typing import Dict, Optional

import torch

from repro_torch import obs
from repro_torch.kernels._matmul_common import DEFAULT_TILES, TileConfig, gemm_tile, sm_count
from repro_torch.kernels.modes import QuantMode
from repro_torch.resilience import faults

__all__ = ["Plan", "PlanCache", "plan_key", "bucket_m", "device_kind",
           "default_cache_path", "get_cache", "set_cache_path",
           "plan_for", "default_plan", "contained", "get_policy", "set_policy",
           "ENV_CACHE_PATH", "SCHEMA_VERSION", "POLICIES"]

ENV_CACHE_PATH = "REPRO_TUNE_CACHE"
SCHEMA_VERSION = 1

# Runtime autotune policy — what a plan-cache MISS does at dispatch time:
#   "off"          -> the default plan (never measure)
#   "on_first_use" -> ops.qmm tunes the shape synchronously on its first
#                     call, then every later call hits the cache
POLICIES = ("off", "on_first_use")
_POLICY = "off"


def get_policy() -> str:
    return _POLICY


def set_policy(policy: str) -> None:
    global _POLICY
    if policy not in POLICIES:
        raise ValueError(f"autotune policy must be one of {POLICIES}, "
                         f"got {policy!r}")
    _POLICY = policy


@dataclasses.dataclass(frozen=True)
class Plan:
    """One tuned (or default) blocking decision.  ``layout`` is the
    registry's ("gemm" | "im2col_fused"); conv plans carry a ``geom``
    tag (e.g. "3x3s1same")."""
    mode: QuantMode
    backend: str
    fused: bool
    device_kind: str
    m_bucket: int
    n: int
    k: int
    tiles: TileConfig
    source: str = "tuned"          # "tuned" | "default"
    layout: str = "gemm"
    geom: Optional[str] = None

    @property
    def key(self) -> str:
        return plan_key(self.mode, self.backend, self.fused,
                        self.device_kind, self.m_bucket, self.n, self.k,
                        layout=self.layout, geom=self.geom)

    def to_json(self) -> Dict:
        out = {"mode": self.mode.value, "backend": self.backend,
               "fused": self.fused, "device_kind": self.device_kind,
               "m_bucket": self.m_bucket, "n": self.n, "k": self.k,
               "tiles": self.tiles.to_json(), "source": self.source,
               "layout": self.layout}
        if self.geom is not None:
            out["geom"] = self.geom
        return out

    @classmethod
    def from_json(cls, d: Dict) -> "Plan":
        return cls(mode=QuantMode(d["mode"]), backend=str(d["backend"]),
                   fused=bool(d["fused"]), device_kind=str(d["device_kind"]),
                   m_bucket=int(d["m_bucket"]), n=int(d["n"]), k=int(d["k"]),
                   tiles=TileConfig.from_json(d["tiles"]),
                   source=str(d.get("source", "tuned")),
                   layout=str(d.get("layout", "gemm")),
                   geom=None if d.get("geom") is None else str(d["geom"]))


def bucket_m(m: int) -> int:
    """Next power of two >= m (min 8): decode and ragged prefill batches
    with nearby m share one plan."""
    b = 8
    while b < m:
        b *= 2
    return b


_KINDS: Dict[str, str] = {}


def _device(device=None) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def device_kind(device=None) -> str:
    """Sanitized kind of ``device`` (default: the current CUDA device, or
    the CPU without a card): ``"nvidia-h100-80gb-hbm3"``, ``"cpu"``."""
    dev = _device(device)
    if dev.type != "cuda":
        return dev.type
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    key = f"cuda:{idx}"
    kind = _KINDS.get(key)
    if kind is None:
        kind = _KINDS[key] = re.sub(r"\s+", "-", torch.cuda.get_device_name(idx).strip().lower())
    return kind


def plan_key(mode: QuantMode, backend: str, fused: bool, dev: str,
             m_bucket: int, n: int, k: int, *, layout: str = "gemm",
             geom: Optional[str] = None) -> str:
    """Cache key for one problem, in the reference's format."""
    fu = "fused" if fused else "unfused"
    if layout == "gemm":
        return f"{mode.value}/{backend}/{fu}/{dev}/m{m_bucket}/n{n}/k{k}"
    return (f"{mode.value}/{backend}/{fu}/{layout}/{geom}/{dev}"
            f"/m{m_bucket}/n{n}/k{k}")


def default_cache_path() -> str:
    env = os.environ.get(ENV_CACHE_PATH)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "tune_plans.json")


@contextlib.contextmanager
def _save_lock(path: str):
    """Advisory inter-process writer lock for one cache file: flock on
    ``<path>.lock``, so two processes tuning against one cache serialize
    their load-merge-replace sections.  Where ``fcntl`` is unavailable
    the lock is a no-op and the atomic rename is the only guarantee."""
    try:
        import fcntl
    except ImportError:                        # non-POSIX
        yield
        return
    lock_path = path + ".lock"
    os.makedirs(os.path.dirname(os.path.abspath(lock_path)) or ".", exist_ok=True)
    with open(lock_path, "a") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


def _cleanup_stale_tmp(path: str, max_age_s: float = 300.0) -> None:
    """Remove ``.tune_plans.*.tmp`` files a crashed writer left next to
    ``path``; age-gated so a live writer's temp file is never removed."""
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    try:
        stale = glob.glob(os.path.join(dirname, ".tune_plans.*.tmp"))
    except OSError:
        return
    now = time.time()
    for tmp in stale:
        try:
            if now - os.path.getmtime(tmp) > max_age_s:
                os.unlink(tmp)
        except OSError:
            continue


class PlanCache:
    """In-memory plan table backed by one atomic JSON file, with the memo
    of resolved plans :func:`plan_for` reads."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self._plans: Dict[str, Plan] = {}
        self._loaded = False
        self.resolved: Dict[tuple, Plan] = {}

    def load(self) -> "PlanCache":
        """(Re)read the backing file.  A missing or corrupt file — or any
        other read failure — yields an empty table (with a warning for
        the corrupt case); lookups then give the default plan."""
        self._plans = {}
        self.resolved = {}
        self._loaded = True
        _cleanup_stale_tmp(self.path)
        try:
            if faults.fire("plan_cache.io", op="load", path=self.path):
                raise OSError("injected plan-cache read failure")
            with open(self.path, "r") as f:
                raw = json.load(f)
            if faults.fire("plan_cache.corrupt", path=self.path):
                raise ValueError("injected plan-cache corruption")
            if not isinstance(raw, dict) or "plans" not in raw:
                raise ValueError("missing 'plans' table")
            for key, d in raw["plans"].items():
                plan = Plan.from_json(d)
                if plan.key != key:
                    raise ValueError(f"key mismatch: {key!r} vs computed {plan.key!r}")
                self._plans[key] = plan
        except FileNotFoundError:
            pass
        except Exception as e:
            warnings.warn(f"corrupt tune plan cache at {self.path} ({e}); ignoring "
                          f"it and falling back to the default plans", stacklevel=2)
            self._plans = {}
        return self

    def save(self) -> None:
        """Atomic write: temp file in the destination directory, fsync,
        ``os.replace``, under the writer lock, merged with the file on
        disk (this process's plans win a per-key conflict)."""
        self._ensure_loaded()
        if faults.fire("plan_cache.io", op="save", path=self.path):
            raise OSError("injected plan-cache write failure")
        dirname = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(dirname, exist_ok=True)
        with _save_lock(self.path):
            disk = PlanCache(self.path).load()._plans
            self._plans = {**disk, **self._plans}
            self.resolved = {}
            payload = {"version": SCHEMA_VERSION,
                       "plans": {k: p.to_json() for k, p in sorted(self._plans.items())}}
            fd, tmp = tempfile.mkstemp(prefix=".tune_plans.", suffix=".tmp", dir=dirname)
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f, indent=2, sort_keys=True)
                    f.write("\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

    def _ensure_loaded(self):
        if not self._loaded:
            self.load()

    def get(self, key: str) -> Optional[Plan]:
        self._ensure_loaded()
        return self._plans.get(key)

    def put(self, plan: Plan) -> None:
        self._ensure_loaded()
        self._plans[plan.key] = plan
        self.resolved = {}

    def plans(self) -> Dict[str, Plan]:
        self._ensure_loaded()
        return dict(self._plans)

    def __len__(self) -> int:
        self._ensure_loaded()
        return len(self._plans)


_CACHE: Optional[PlanCache] = None


def get_cache() -> PlanCache:
    global _CACHE
    if _CACHE is None or _CACHE.path != default_cache_path():
        _CACHE = PlanCache()       # the env override changed: re-resolve
    return _CACHE


def set_cache_path(path: Optional[str]) -> PlanCache:
    """Point the process-wide cache at ``path`` (None: re-resolve from
    the environment).  Returns the new active cache."""
    global _CACHE
    if path is None:
        os.environ.pop(ENV_CACHE_PATH, None)
    else:
        os.environ[ENV_CACHE_PATH] = path
    _CACHE = PlanCache()
    return _CACHE


def default_tiles(mode: QuantMode, backend: str, fused: bool, m: int, n: int,
                  layout: str = "gemm", device=None) -> TileConfig:
    """The untuned blocking of a registry cell: ``gemm_tile``'s CTA tile
    over the cell's tiles for a CUDA GeMM cell on a card (None on the
    CPU), else the mode's ``DEFAULT_TILES``."""
    from repro_torch.kernels import ops, registry   # noqa: F401  (ops registers the cells)

    space = None
    if registry.has(mode, backend, fused=fused, layout=layout):
        space = registry.lookup(mode, backend, fused=fused, layout=layout).tunable
    if space is not None and space.kind == "cuda":
        dev = _device(device)
        if dev.type != "cuda":
            return TileConfig()
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        return TileConfig(cta_tile=gemm_tile(m, n, sm_count(idx), space.cta_tile))
    return DEFAULT_TILES.get(mode.value, TileConfig())


def default_plan(mode: QuantMode, backend: str, fused: bool, m: int, n: int, k: int, *,
                 layout: str = "gemm", geom: Optional[str] = None, device=None) -> Plan:
    """The deterministic no-cache plan: :func:`default_tiles`."""
    return Plan(mode=mode, backend=backend, fused=fused, device_kind=device_kind(device),
                m_bucket=bucket_m(m), n=n, k=k,
                tiles=default_tiles(mode, backend, fused, m, n, layout, device),
                source="default", layout=layout, geom=geom)


# Dispatch-time plan telemetry (process registry; no-ops when
# REPRO_OBS=off).  "result": hit = tuned plan, default = fallback.
_LOOKUP_CTR = obs.get_registry().counter(
    "repro_tune_plan_lookups_total",
    "plan_for cache lookups by result (hit | default)",
    labels=("result",))
_RESOLVE_HIST = obs.get_registry().histogram(
    "repro_tune_plan_resolve_seconds",
    "plan_for resolution latency (pure lookup, no measuring)")
_CONTAIN_CTR = obs.get_registry().counter(
    "repro_tune_contained_total",
    "tune-plane failures contained to the default plan by site "
    "(plan_for | ensure_plan | save)",
    labels=("site",))


def contained(site: str, err: Exception) -> None:
    """Record one contained tune-plane failure (counter + obs event +
    warning): nothing in the tune plane may take a dispatch down."""
    _CONTAIN_CTR.inc(site=site)
    faults.emit_event("tune_contained", site=site, error=f"{type(err).__name__}: {err}")
    warnings.warn(f"tune {site} failed ({type(err).__name__}: {err}); "
                  f"contained — falling back to the default plan", stacklevel=3)


def plan_for(mode: QuantMode, backend: str, *, fused: bool, m: int, n: int, k: int,
             layout: str = "gemm", geom: Optional[str] = None, device=None) -> Plan:
    """Dispatch-time lookup (never measures): the tuned plan on a cache
    hit, else the default plan.  Memoized per problem on the cache (the
    memo is dropped when its table changes), so a repeated request costs
    one dict lookup; a first resolution is timed in
    ``repro_tune_plan_resolve_seconds``."""
    memo_key = (mode, backend, fused, m, n, k, layout, geom, str(device))
    try:
        cache = get_cache()
        plan = cache.resolved.get(memo_key)
        if plan is None:
            with _RESOLVE_HIST.time():
                dev = device_kind(device)
                plan = cache.get(plan_key(mode, backend, fused, dev, bucket_m(m), n, k,
                                          layout=layout, geom=geom))
                if plan is None:
                    plan = default_plan(mode, backend, fused, m, n, k, layout=layout,
                                        geom=geom, device=device)
            cache.resolved[memo_key] = plan
    except Exception as e:
        # a broken cache (or device query) resolves to the untuned
        # blocking, never into the kernel dispatch
        contained("plan_for", e)
        plan = Plan(mode=mode, backend=backend, fused=fused, device_kind="unknown",
                    m_bucket=bucket_m(m), n=n, k=k,
                    tiles=DEFAULT_TILES.get(mode.value, TileConfig()),
                    source="default", layout=layout, geom=geom)
    _LOOKUP_CTR.inc(result="hit" if plan.source == "tuned" else "default")
    return plan
