"""The port's watchdog and elastic planner (``repro_torch.runtime``)
against the JAX package's, on the CPU.  Both are pure Python: the same
heartbeat and clock sequences must give equal reports at every check,
and ``plan_restart`` equal plans over the reference's grid."""

import dataclasses

import numpy as np
import pytest

from repro.runtime import Watchdog as JWatchdog
from repro.runtime import WatchdogConfig as JWatchdogConfig
from repro.runtime import plan_restart as jplan_restart
from repro_torch.runtime import Watchdog, WatchdogConfig, plan_restart


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _script(seed, hosts=4, ticks=40):
    """A seeded heartbeat schedule: per tick, (clock advance, {host:
    step time}) — slow hosts, silent hosts, recoveries."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(ticks):
        beats = {}
        for h in range(hosts):
            r = rng.random()
            if r < 0.1:
                continue                        # silent this tick
            beats[h] = float(3.0 if r > 0.8 else 1.0 + 0.1 * rng.random())
        out.append((float(rng.choice([1.0, 5.0, 60.0])), beats))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_watchdog_reports_equal_reference(seed):
    kw = dict(dead_after_s=100.0, straggler_factor=1.5, window=4, grace_steps=3)
    c1, c2 = FakeClock(), FakeClock()
    wd = Watchdog(WatchdogConfig(**kw), num_hosts=4, clock=c1)
    jwd = JWatchdog(JWatchdogConfig(**kw), num_hosts=4, clock=c2)
    fired = 0
    for dt, beats in _script(seed):
        c1.t += dt
        c2.t += dt
        for h, s in beats.items():
            wd.heartbeat(h, s)
            jwd.heartbeat(h, s)
        got, want = wd.check(), jwd.check()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.healthy == want.healthy
        fired += not got.healthy
    assert fired        # the schedules do exercise the unhealthy paths


def test_dead_host_detected():
    clock = FakeClock()
    wd = Watchdog(WatchdogConfig(dead_after_s=100.0, window=4, grace_steps=3),
                  num_hosts=4, clock=clock)
    for h in range(4):
        wd.heartbeat(h, 1.0)
    clock.t = 160.0
    for h in range(3):
        wd.heartbeat(h, 1.0)
    assert wd.check().dead == [3]


@pytest.mark.parametrize("chips", [0, 8, 15, 16, 17, 64, 140, 255, 256, 300, 384,
                                   511, 512, 1024])
@pytest.mark.parametrize("model,old_data,old_pods", [(16, 16, 2), (8, 16, 1), (4, 8, 4)])
def test_plan_restart_equal_reference(chips, model, old_data, old_pods):
    kw = dict(chips_per_pod=256, model=model, old_data=old_data, old_pods=old_pods)
    got, want = plan_restart(chips, **kw), jplan_restart(chips, **kw)
    if want is None:
        assert got is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.chips == want.chips
    assert got.mesh_shape(True) == want.mesh_shape(True)
    assert got.mesh_shape(False) == want.mesh_shape(False)
