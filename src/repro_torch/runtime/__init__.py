"""Runtime resilience: heartbeat watchdog (dead/straggler detection)
and elastic mesh re-planning after device loss — consumed by the
Trainer.  Counterpart of ``repro/runtime``."""

from repro_torch.runtime.elastic import ElasticPlan, plan_restart
from repro_torch.runtime.fault_tolerance import StragglerReport, Watchdog, WatchdogConfig

__all__ = ["Watchdog", "WatchdogConfig", "StragglerReport", "ElasticPlan",
           "plan_restart"]
