"""The device's idle share: 1 - the union of the device operations'
intervals in the profiled units over the same number of units'
unprofiled wall time from the window, in %."""


def read(trace):
    if not trace.device_ops or trace.unit_wall_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / (trace.units * trace.unit_wall_s))
