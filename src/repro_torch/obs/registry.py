"""Zero-dependency metrics registry: Counter / Gauge / Histogram with
labels, thread-safe, hard-disabled to a no-op by ``REPRO_OBS=off``.

Design points:

* **instruments are handles** — ``registry.counter(name, ...)`` is
  get-or-create (idempotent; re-declaring with a different type or
  label set raises), so call sites keep module-level handles and the
  hot path is one bound-method call;
* **off is a no-op, not an absence** — when the registry is disabled
  (``REPRO_OBS=off`` or ``enabled=False``), every record method returns
  after ONE attribute lookup (``self._on``); instruments still exist,
  so ``snapshot()`` stays well-formed and enabling later just starts
  recording.  Instruments created with ``always=True`` record
  regardless of the switch (the reference uses them for its jit
  retrace counters, which the port has no counterpart of);
* **monotonic timers** — :func:`timer` / :meth:`Histogram.time` use
  ``time.perf_counter`` so latency observations never go backwards
  under wall-clock adjustment;
* **thread-safe** — one registry-wide lock guards every series table
  (coarse by design: metric updates are nanoseconds next to the
  device work they count).

``snapshot()`` returns the nested-dict form everything else consumes
(``python -m repro_torch.obs`` renders it as Prometheus text; the
catalog check validates its names).  Counterpart of
``repro/obs/registry.py``, copied: the environment variable, the
snapshot schema and its format are the reference's, so either
package's checker reads the other's snapshots.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

__all__ = [
    "ENV_OBS", "SNAPSHOT_SCHEMA_VERSION", "obs_enabled", "set_enabled",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "timer", "to_prometheus", "DEFAULT_BUCKETS",
]

ENV_OBS = "REPRO_OBS"
SNAPSHOT_SCHEMA_VERSION = 1

# Default latency buckets (seconds): decode steps land around 10-100
# ms; TTFT with chunked prefill in the 0.1-10 s decades.  Upper bound is +inf implicitly (count - sum(buckets)).
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0)

# Process-wide switch.  Resolved once from the environment at import;
# set_enabled() lets tests (and embedders) flip it without re-exec.
_ENABLED = os.environ.get(ENV_OBS, "on").strip().lower() != "off"


def obs_enabled() -> bool:
    """Process-wide telemetry switch (``REPRO_OBS`` env; default on)."""
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Flip the process-wide switch.  Registries created with
    ``enabled=None`` (the default) track this live; registries built
    with an explicit ``enabled=`` keep their own setting."""
    global _ENABLED
    _ENABLED = bool(on)


class _Instrument:
    """Shared series-table plumbing for the three instrument types."""

    kind = "?"

    def __init__(self, registry: "MetricsRegistry", name: str,
                 help: str, labels: Tuple[str, ...], always: bool):
        self._reg = registry
        self.name = name
        self.help = help
        self.label_names = labels
        self.always = always
        self._series: Dict[Tuple[str, ...], object] = {}

    @property
    def _on(self) -> bool:
        return self.always or self._reg.enabled

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if tuple(sorted(labels)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.label_names)

    def _snapshot_value(self, raw):
        return raw

    def snapshot(self) -> Dict:
        with self._reg._lock:
            series = [{"labels": dict(zip(self.label_names, key)),
                       "value": self._snapshot_value(raw)}
                      for key, raw in sorted(self._series.items())]
        return {"type": self.kind, "help": self.help,
                "labels": list(self.label_names), "series": series}


class Counter(_Instrument):
    """Monotonically increasing count (optionally labelled)."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if not self._on:
            return
        key = self._key(labels)
        with self._reg._lock:
            self._series[key] = self._series.get(key, 0) + n

    def value(self, **labels) -> float:
        """Current value of one series (0 if never incremented).  Read
        path — works whether or not the registry is enabled."""
        key = self._key(labels)
        with self._reg._lock:
            return self._series.get(key, 0)

    def total(self) -> float:
        """Sum across every label combination."""
        with self._reg._lock:
            return sum(self._series.values())


class Gauge(_Instrument):
    """Point-in-time value; ``set`` overwrites, ``high_water`` keeps the
    max seen (page-pool high-water marks and the like)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        if not self._on:
            return
        key = self._key(labels)
        with self._reg._lock:
            self._series[key] = v

    def high_water(self, v: float, **labels) -> None:
        if not self._on:
            return
        key = self._key(labels)
        with self._reg._lock:
            cur = self._series.get(key)
            if cur is None or v > cur:
                self._series[key] = v

    def value(self, **labels) -> Optional[float]:
        key = self._key(labels)
        with self._reg._lock:
            return self._series.get(key)


class Histogram(_Instrument):
    """Fixed-bucket histogram (count / sum / cumulative-style buckets).

    Buckets store the count of observations ``<= upper_bound``; the
    implicit +inf bucket is ``count``.
    """

    kind = "histogram"

    def __init__(self, registry, name, help, labels, always,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(registry, name, help, labels, always)
        self.buckets = tuple(sorted(buckets))

    def observe(self, v: float, **labels) -> None:
        if not self._on:
            return
        key = self._key(labels)
        with self._reg._lock:
            raw = self._series.get(key)
            if raw is None:
                raw = {"count": 0, "sum": 0.0,
                       "buckets": [0] * len(self.buckets)}
                self._series[key] = raw
            raw["count"] += 1
            raw["sum"] += v
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    raw["buckets"][i] += 1

    @contextlib.contextmanager
    def time(self, **labels):
        """Observe the monotonic duration of the with-block."""
        if not self._on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0, **labels)

    def count(self, **labels) -> int:
        key = self._key(labels)
        with self._reg._lock:
            raw = self._series.get(key)
            return 0 if raw is None else int(raw["count"])

    def sum(self, **labels) -> float:
        key = self._key(labels)
        with self._reg._lock:
            raw = self._series.get(key)
            return 0.0 if raw is None else float(raw["sum"])

    def _snapshot_value(self, raw):
        return {"count": raw["count"], "sum": raw["sum"],
                "buckets": {str(ub): c for ub, c in
                            zip(self.buckets, raw["buckets"])}}


timer = Histogram.time          # obs.timer(hist, ...) reads naturally


class MetricsRegistry:
    """Named instrument table with one shared lock.

    ``enabled=None`` (default) tracks the process-wide ``REPRO_OBS``
    switch live; an explicit bool pins this registry regardless.
    """

    def __init__(self, enabled: Optional[bool] = None):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Instrument] = {}
        self._enabled = enabled

    @property
    def enabled(self) -> bool:
        return _ENABLED if self._enabled is None else self._enabled

    @enabled.setter
    def enabled(self, on: Optional[bool]) -> None:
        self._enabled = on

    def _get_or_create(self, cls, name: str, help: str,
                       labels: Iterable[str], always: bool, **kw):
        labels = tuple(labels)
        with self._lock:
            cur = self._metrics.get(name)
            if cur is not None:
                if type(cur) is not cls or cur.label_names != labels:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{cur.kind}{cur.label_names}, cannot re-register "
                        f"as {cls.kind}{labels}")
                return cur
            inst = cls(self, name, help, labels, always, **kw)
            self._metrics[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = (), always: bool = False) -> Counter:
        return self._get_or_create(Counter, name, help, labels, always)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = (), always: bool = False) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels, always)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (), always: bool = False,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels, always,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._metrics))

    def snapshot(self) -> Dict:
        """The canonical nested-dict export (see module docstring)."""
        return {"schema": SNAPSHOT_SCHEMA_VERSION,
                "metrics": {name: self._metrics[name].snapshot()
                            for name in self.names()}}

    def reset(self) -> None:
        """Drop every recorded series (instruments stay registered).
        Test/bench plumbing — production readers diff snapshots."""
        with self._lock:
            for inst in self._metrics.values():
                inst._series = {}


# Process-wide default registry: the kernel / tune / fault layers record
# here; serving engines keep a private registry per engine (plus this
# one, via Engine.snapshot()'s "process" section).
_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _DEFAULT


def _fmt_labels(labels: Dict[str, str], extra: Optional[Tuple[str, str]] = None
                ) -> str:
    items = list(labels.items()) + ([extra] if extra else [])
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


def to_prometheus(snapshot: Dict) -> str:
    """Render one registry snapshot as Prometheus text exposition."""
    lines = []
    for name, m in snapshot.get("metrics", {}).items():
        if m.get("help"):
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {m['type']}")
        for s in m["series"]:
            if m["type"] == "histogram":
                v = s["value"]
                for ub, c in v["buckets"].items():
                    lines.append(f"{name}_bucket"
                                 f"{_fmt_labels(s['labels'], ('le', ub))} {c}")
                lines.append(f"{name}_bucket"
                             f"{_fmt_labels(s['labels'], ('le', '+Inf'))} "
                             f"{v['count']}")
                lines.append(f"{name}_sum{_fmt_labels(s['labels'])} "
                             f"{v['sum']}")
                lines.append(f"{name}_count{_fmt_labels(s['labels'])} "
                             f"{v['count']}")
            else:
                lines.append(f"{name}{_fmt_labels(s['labels'])} "
                             f"{s['value']}")
    return "\n".join(lines) + ("\n" if lines else "")
