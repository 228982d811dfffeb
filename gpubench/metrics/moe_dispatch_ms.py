"""Device ms per unit in the MoE layer's dispatch stage: kernels launched
inside ``repro_torch.moe.dispatch`` (the sort of the choices by expert, the per-expert counts and their host read, the row gather)."""

from gpubench import spans


def read(trace):
    return spans.device_ms(trace, "repro_torch.moe.dispatch")
