"""Device time a unit: the union of the device operations' intervals in
the profiled units, in ms."""


def read(trace):
    if not trace.device_ops:
        return None
    return trace.busy_s * 1e3 / trace.units
