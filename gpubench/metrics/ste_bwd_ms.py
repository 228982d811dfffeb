"""Device ms per unit in the straight-through backward of the quantized
projections: kernels launched inside ``repro_torch.ste_backward`` (the
float32 products and the clip mask)."""

from gpubench import spans


def read(trace):
    return spans.device_ms(trace, "repro_torch.ste_backward")
