"""Heartbeat / straggler watchdog.

Counterpart of ``repro/runtime/fault_tolerance.py`` (pure Python, the
same reports from the same heartbeats and clock).

On a real multi-host job every host reports a heartbeat (step, wall
time) after each training step; host 0 aggregates them.  The watchdog
flags:

* **dead hosts** — no heartbeat for ``dead_after_s``;
* **stragglers** — hosts whose rolling median step time exceeds the
  fleet median by ``straggler_factor`` (persistent slowness = failing
  HBM/NIC, thermal throttling, a noisy neighbour ...).

Reaction policy (wired in Trainer): a dead host triggers the elastic
restart path (checkpoint -> re-plan mesh without the host -> restore);
a straggler first gets ``grace`` steps to recover, then is treated as
dead.  The assignment's container is single-host, so the timing source
is injectable (tests drive it with a fake clock) — the *logic* is what
ships.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List

__all__ = ["WatchdogConfig", "StragglerReport", "Watchdog"]


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    dead_after_s: float = 300.0
    straggler_factor: float = 1.5
    window: int = 16              # rolling step-time window per host
    grace_steps: int = 8


@dataclasses.dataclass
class StragglerReport:
    dead: List[int]
    stragglers: List[int]
    fleet_median_s: float

    @property
    def healthy(self) -> bool:
        return not self.dead and not self.stragglers


class Watchdog:
    def __init__(self, cfg: WatchdogConfig, num_hosts: int,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.num_hosts = num_hosts
        self.clock = clock
        self._last_seen: Dict[int, float] = {}
        self._times: Dict[int, deque] = defaultdict(
            lambda: deque(maxlen=cfg.window))
        self._strikes: Dict[int, int] = defaultdict(int)

    def heartbeat(self, host_id: int, step_time_s: float):
        self._last_seen[host_id] = self.clock()
        self._times[host_id].append(step_time_s)

    @staticmethod
    def _median(xs: List[float]) -> float:
        xs = sorted(xs)
        n = len(xs)
        return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])

    def check(self) -> StragglerReport:
        now = self.clock()
        dead = [h for h in range(self.num_hosts)
                if now - self._last_seen.get(h, -1e18) > self.cfg.dead_after_s]

        medians = {h: self._median(list(t)) for h, t in self._times.items() if t}
        fleet = self._median(list(medians.values())) if medians else 0.0
        stragglers = []
        for h, m in medians.items():
            if h in dead:
                continue
            if fleet > 0 and m > self.cfg.straggler_factor * fleet:
                self._strikes[h] += 1
                if self._strikes[h] >= self.cfg.grace_steps:
                    stragglers.append(h)
            else:
                self._strikes[h] = 0
        return StragglerReport(dead=dead, stragglers=sorted(stragglers),
                               fleet_median_s=fleet)
