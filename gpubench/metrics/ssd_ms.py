"""Device ms per unit in the Mamba2 mixer between its projections:
kernels launched inside ``repro_torch.ssd`` (causal conv, chunked scan,
gate, norm; in a QAT step the remat recompute's too)."""

from gpubench import spans


def read(trace):
    return spans.device_ms(trace, "repro_torch.ssd")
