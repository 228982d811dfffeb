"""Device ms per unit in the entry points' own work: kernels launched
inside ``repro_torch.qmm`` or ``repro_torch.qconv`` but outside their
quantize and kernel-launch spans (casts, copies, scale vectors)."""

from gpubench import spans


def read(trace):
    return spans.device_ms(trace, "repro_torch.qmm", "repro_torch.qconv")
