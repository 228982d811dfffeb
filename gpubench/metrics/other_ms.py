"""Device ms per unit that no program span below the unit's claims: the
kernels the unit and phase spans launched themselves (embedding, norms,
residual adds, the loss, the head), the kernels launched in no program
span (the benchmark's own: the prefill's fresh cache) and those found no
launch for."""

from gpubench import spans


def read(trace):
    sp = spans.of(trace)
    if not sp.found:
        return None
    names = spans.UNIT_SPANS + (spans.NONE,)
    return sum(sp.get(n).device_s for n in names) * 1e3 / trace.units
