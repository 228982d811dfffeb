"""The popcount GeMM's share of its roofline: the bound of every fused
GeMM a unit runs (``work["gemm"]``, from the projections' shapes) over
the device time of ``lowbit_gemm_kernel`` per unit, in %."""

from gpubench.work.roofline import bound_ms


def read(trace):
    if "gemm" not in trace.work:
        return None
    s = trace.kernel_s(lambda n: "lowbit_gemm_kernel" in n)
    if s <= 0:
        return None
    return 100.0 * bound_ms(trace.work["gemm"]) / (s * 1e3 / trace.units)
