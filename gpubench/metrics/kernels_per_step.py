"""Device kernels launched per unit (copies and fills not counted)."""


def read(trace):
    kernels = trace.kernels
    return len(kernels) / trace.units if kernels else None
