"""Device ms per unit in kernels that are neither the port's hand-written
ones nor library matrix products: PyTorch's elementwise work,
reductions, copies inside the models and the entry points."""

from gpubench import harness


def read(trace):
    kernels = trace.kernels
    if not kernels:
        return None
    glue = sum(e - s for name, s, e in kernels
               if not harness.is_port_kernel(name) and not harness.is_float_gemm(name))
    return glue * 1e3 / trace.units
