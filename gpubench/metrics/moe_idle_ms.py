"""Device-idle ms per unit that began while the host was inside a
``repro_torch.moe.*`` span (at any depth: in the ``qmm`` of an expert
too): the host reading the per-expert counts and launching the expert
loop's kernels one after another.  The profiler slows the host, so the
traced stretch idles longer than the window: the idle gaps that began
in those spans, as a share of the stretch's idle time, times the idle
time a unit had in the window (its wall time less the stretch's busy
time a unit), as ``idle_share`` reads it.  The gaps go to the MoE spans
alone (:func:`spans.attribute` over them), so a gap inside an expert's
``qmm`` counts under the stage that holds it."""

from gpubench import spans


def read(trace):
    moe = [h for h in trace.host_ops if h[0].startswith("repro_torch.moe.")]
    if not moe or not trace.device_ops or trace.unit_wall_s <= 0:
        return None
    busy = trace.busy_intervals()
    gaps = [(e0, s1 - e0) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    idle = sum(length for _, length in gaps)
    if idle <= 0:
        return 0.0
    by_stage = spans.attribute(moe, [], gaps)
    share = sum(t.idle_s for name, t in by_stage.items() if name != spans.NONE) / idle
    return share * max(trace.unit_wall_s - trace.busy_s / trace.units, 0.0) * 1e3
