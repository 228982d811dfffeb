"""The low-bit convs' share of their roofline: the bound of every packing
pass and popcount conv of a unit (``work["conv"]``, from shapes) over the
device time of ``conv_pack_kernel`` and ``lowbit_conv_kernel`` per unit,
in %."""

from gpubench.work.roofline import bound_ms


def read(trace):
    if "conv" not in trace.work:
        return None
    ms = trace.kernel_s(lambda n: "conv_pack_kernel" in n or "lowbit_conv_kernel" in n)
    if ms <= 0:
        return None
    return 100.0 * bound_ms(trace.work["conv"]) / (ms * 1e3 / trace.units)
