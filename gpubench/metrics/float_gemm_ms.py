"""Device ms per unit in library (cuBLAS / CUTLASS) float matrix products:
in a QAT step the straight-through backward's and the head's."""

from gpubench import harness


def read(trace):
    if not trace.kernels:
        return None
    return trace.kernel_s(harness.is_float_gemm) * 1e3 / trace.units
