"""Deterministic, seeded fault-injection plane.

Counterpart of ``repro/resilience/faults.py``, copied: the same points,
plan grammar, ``REPRO_FAULTS`` variable and seeded rate streams, so one
plan with one seed fires at the same hits in both packages.

Production code is instrumented with *named injection points* — each a
single call to :func:`fire` (returns bool) or :func:`maybe_raise`
(raises :class:`InjectedFault`).  Disarmed — the default — every point
is one module-global ``is None`` check: no RNG, no dict lookup, no
allocation, so the instrumented hot paths carry no overhead.

Armed, a :class:`FaultPlan` decides *deterministically* whether a given
hit of a given point fires:

* ``FaultSpec(point, hits=(2, 5))`` — fire on the 3rd and 6th matching
  hit of that point (0-based), exactly reproducible run over run;
* ``FaultSpec(point, rate=0.1)`` — Bernoulli per hit on a stream seeded
  by ``(plan.seed, point)``, so a given seed replays the same firings;
* ``match={"backend": "cuda"}`` — the spec only counts/fires hits
  whose call-site context matches every given key (context keys a spec
  names but a call site omits never match).

Arming is explicit (:func:`arm` / :func:`disarm`) or environmental:
``REPRO_FAULTS`` is parsed at import via :func:`plan_from_env` and
armed when non-empty.  Env grammar — entries split on ``;`` or ``,``:

    REPRO_FAULTS="kernel.compile@0?backend=cuda;pages.exhausted@1+4;
                  logits.nan:0.05;seed=7;stall=0.002"

``point@i+j`` gives explicit hit indices, ``point:p`` a rate,
``?k=v&k=v`` a context match, ``seed=N``/``stall=S`` set the plan seed
and the stall duration (seconds) used by :func:`maybe_stall`.

Every firing increments ``repro_faults_injected_total{point=...}`` and
appends a ``fault_injected`` record to the process obs event log, so a
chaos run's event stream is an auditable record of exactly which
faults fired where (``python -m repro_torch.obs --events ... --check``).
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
import warnings
import zlib
from typing import Any, Dict, Optional, Tuple

from repro_torch import obs

__all__ = ["POINTS", "ENV_FAULTS", "FaultSpec", "FaultPlan",
           "InjectedFault", "arm", "disarm", "active", "fire",
           "maybe_raise", "maybe_stall", "emit_event", "plan_from_env",
           "parse_plan"]

ENV_FAULTS = "REPRO_FAULTS"

# The registered injection points.  Firing an unregistered name is a
# programming error (typo'd site or typo'd plan) and raises ValueError.
POINTS: Dict[str, str] = {
    "kernel.compile": "kernel build/launch failure at qmm/qconv "
                      "dispatch (ctx: op, mode, backend)",
    "plan_cache.io": "tune plan-cache read/write OSError (ctx: op, path)",
    "plan_cache.corrupt": "tune plan-cache parses but holds garbage "
                          "(ctx: path)",
    "pages.exhausted": "KV page-pool allocation failure (ctx: want)",
    "device.loss": "device loss mid scheduler step (ctx: -)",
    "logits.nan": "NaN/Inf decode logits for one live row (ctx: op)",
    "step.stall": "slow scheduler step; maybe_stall sleeps stall_s "
                  "(ctx: -)",
}


class InjectedFault(RuntimeError):
    """Raised by :func:`maybe_raise` when an armed plan fires a point."""

    def __init__(self, point: str, hit: int, **ctx: Any):
        self.point = point
        self.hit = hit
        self.ctx = ctx
        extra = f" ctx={ctx}" if ctx else ""
        super().__init__(f"injected fault {point!r} (hit {hit}){extra}")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One point's firing schedule inside a :class:`FaultPlan`."""
    point: str
    hits: Tuple[int, ...] = ()        # explicit 0-based hit indices
    rate: float = 0.0                 # per-hit Bernoulli on seeded stream
    match: Optional[Dict[str, str]] = None  # ctx filter (str-compared)
    max_fires: Optional[int] = None   # stop firing after this many

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(f"unknown fault point {self.point!r}; "
                             f"registered: {sorted(POINTS)}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")

    def matches(self, ctx: Dict[str, Any]) -> bool:
        if not self.match:
            return True
        return all(k in ctx and str(ctx[k]) == v
                   for k, v in self.match.items())


class FaultPlan:
    """A set of :class:`FaultSpec` schedules + the mutable per-point hit
    and fire counters an armed run accumulates.  Deterministic: the
    rate streams are seeded by ``(seed, point)`` and the hit counters
    advance only on matching hits, so the same plan over the same call
    sequence fires identically every run."""

    def __init__(self, specs, seed: int = 0, stall_s: float = 0.0):
        by_point: Dict[str, FaultSpec] = {}
        for spec in specs:
            if spec.point in by_point:
                raise ValueError(f"duplicate spec for point {spec.point!r}")
            by_point[spec.point] = spec
        self.specs = by_point
        self.seed = int(seed)
        self.stall_s = float(stall_s)
        self.hits: Dict[str, int] = {p: 0 for p in by_point}
        self.fires: Dict[str, int] = {p: 0 for p in by_point}
        self._rng: Dict[str, random.Random] = {
            p: random.Random(self.seed ^ zlib.crc32(p.encode()))
            for p in by_point}

    def should_fire(self, point: str, ctx: Dict[str, Any]) -> int:
        """-1 when the point stays quiet for this hit, else the 0-based
        hit index that fired (advances the point's counters)."""
        spec = self.specs.get(point)
        if spec is None or not spec.matches(ctx):
            return -1
        hit = self.hits[point]
        self.hits[point] = hit + 1
        if spec.max_fires is not None and self.fires[point] >= spec.max_fires:
            return -1
        fired = hit in spec.hits
        if not fired and spec.rate > 0.0:
            fired = self._rng[point].random() < spec.rate
        if not fired:
            return -1
        self.fires[point] += 1
        return hit

    def report(self) -> Dict[str, Dict[str, int]]:
        return {p: {"hits": self.hits[p], "fires": self.fires[p]}
                for p in self.specs}


_PLAN: Optional[FaultPlan] = None

_FIRE_CTR = obs.get_registry().counter(
    "repro_faults_injected_total",
    "fault-plane firings by injection point (resilience/faults.py)",
    labels=("point",))

_EVENTS: Optional[obs.EventLog] = None


def _events() -> obs.EventLog:
    # Process-level sink (engine tag "faults"): kernel/tuner firings
    # happen outside any Engine, so they get their own lazily-opened
    # log at the default path.
    global _EVENTS
    if _EVENTS is None or _EVENTS.closed:
        _EVENTS = obs.EventLog(path=obs.default_events_path(),
                               engine="faults")
    return _EVENTS


def emit_event(kind: str, **fields: Any) -> None:
    """Append one record to the resilience plane's process event log
    (no-op when obs is disabled, like every EventLog)."""
    _events().emit(kind, **fields)


def arm(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` as THE armed plan (returns it for chaining)."""
    global _PLAN
    _PLAN = plan
    return plan


def disarm() -> None:
    """Remove the armed plan: every point reverts to zero-overhead."""
    global _PLAN
    _PLAN = None


def active() -> Optional[FaultPlan]:
    """The armed plan, or None when the plane is disarmed."""
    return _PLAN


def fire(point: str, **ctx: Any) -> bool:
    """True when the armed plan fires ``point`` for this hit.  The
    disarmed fast path is the first line — one global load + ``is``
    check — so instrumented hot paths stay free."""
    if _PLAN is None:
        return False
    if point not in POINTS:
        raise ValueError(f"unknown fault point {point!r}; "
                         f"registered: {sorted(POINTS)}")
    hit = _PLAN.should_fire(point, ctx)
    if hit < 0:
        return False
    _FIRE_CTR.inc(point=point)
    emit_event("fault_injected", point=point, hit=hit,
               **{k: str(v) for k, v in ctx.items()})
    return True


def maybe_raise(point: str, **ctx: Any) -> None:
    """Raise :class:`InjectedFault` when the armed plan fires ``point``."""
    if _PLAN is None:
        return
    if fire(point, **ctx):
        raise InjectedFault(point, _PLAN.hits[point] - 1, **ctx)


def maybe_stall(point: str = "step.stall", **ctx: Any) -> None:
    """Sleep ``plan.stall_s`` when the armed plan fires ``point`` — the
    slow-step fault (watchdog/straggler territory, not an error)."""
    if _PLAN is None:
        return
    if fire(point, **ctx) and _PLAN.stall_s > 0.0:
        time.sleep(_PLAN.stall_s)


def parse_plan(text: str) -> Optional[FaultPlan]:
    """Parse the ``REPRO_FAULTS`` grammar (module docstring) into a
    :class:`FaultPlan`; None when ``text`` holds no specs."""
    specs = []
    seed = 0
    stall_s = 0.0
    for raw in text.replace(";", ",").split(","):
        entry = raw.strip()
        if not entry:
            continue
        if entry.startswith("seed="):
            seed = int(entry[len("seed="):])
            continue
        if entry.startswith("stall="):
            stall_s = float(entry[len("stall="):])
            continue
        match: Optional[Dict[str, str]] = None
        if "?" in entry:
            entry, qs = entry.split("?", 1)
            match = {}
            for pair in qs.split("&"):
                k, _, v = pair.partition("=")
                if not k or not v:
                    raise ValueError(f"bad match clause {pair!r} in "
                                     f"fault entry {raw.strip()!r}")
                match[k] = v
        rate = 0.0
        if ":" in entry:
            entry, rate_s = entry.split(":", 1)
            rate = float(rate_s)
        hits: Tuple[int, ...] = ()
        if "@" in entry:
            entry, hits_s = entry.split("@", 1)
            hits = tuple(int(h) for h in hits_s.split("+"))
        specs.append(FaultSpec(point=entry, hits=hits, rate=rate,
                               match=match))
    if not specs:
        return None
    return FaultPlan(specs, seed=seed, stall_s=stall_s)


def plan_from_env(env: Optional[str] = None) -> Optional[FaultPlan]:
    """Build a plan from ``env`` (default: the ``REPRO_FAULTS``
    variable); None when unset/empty."""
    text = os.environ.get(ENV_FAULTS, "") if env is None else env
    if not text.strip():
        return None
    return parse_plan(text)


def _arm_from_env() -> None:
    # Import-time arming: a malformed REPRO_FAULTS must not take the
    # process down (the plane is an operability tool), so parse errors
    # warn-and-disarm instead of raising.
    try:
        plan = plan_from_env()
    except (ValueError, TypeError) as e:
        warnings.warn(f"ignoring malformed {ENV_FAULTS}: {e}")
        return
    if plan is not None:
        arm(plan)


_arm_from_env()
