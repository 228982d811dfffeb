"""Resilience plane of the port: deterministic fault injection
(:mod:`repro_torch.resilience.faults`) and the consumers that contain a
fault instead of dying.

Counterpart of ``repro/resilience``.  Production code calls
``faults.fire(point)`` / ``faults.maybe_raise(point)`` at named
injection points; a disarmed plane is a single ``is None`` check, an
armed :class:`FaultPlan` decides per hit whether the point fires.  The
consumers: tune plan-cache containment (:mod:`repro_torch.tune`) and
the scheduler's backpressure, preemption, numeric quarantine and step
quarantine (:mod:`repro_torch.serving.scheduler`).  Unlike the
reference, the kernel layer has no fallback chain: an injected
``kernel.compile`` (or a failed CUDA launch) raises to the caller, and
``Engine.run`` quarantines the step.
"""

from repro_torch.resilience.faults import (  # noqa: F401
    POINTS,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    active,
    arm,
    disarm,
    fire,
    maybe_raise,
    maybe_stall,
    parse_plan,
    plan_from_env,
)

__all__ = ["POINTS", "FaultPlan", "FaultSpec", "InjectedFault", "active",
           "arm", "disarm", "fire", "maybe_raise", "maybe_stall",
           "parse_plan", "plan_from_env"]
