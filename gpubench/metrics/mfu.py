"""Share of the H100's peak: the least time of one unit's work (the cell
driver's ``work["step"]``, from shapes, ``gpubench/work``) over the
unprofiled wall time of a unit in the window, in %."""


def read(trace):
    from gpubench.work.roofline import bound_ms

    if "step" not in trace.work or trace.unit_wall_s <= 0:
        return None
    return 100.0 * bound_ms([trace.work["step"]]) / (trace.unit_wall_s * 1e3)
