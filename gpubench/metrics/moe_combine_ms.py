"""Device ms per unit in the MoE layer's combine stage: kernels launched
inside ``repro_torch.moe.combine`` (the weighted sum of each token's experts, the shared expert's gate, the aux loss)."""

from gpubench import spans


def read(trace):
    return spans.device_ms(trace, "repro_torch.moe.combine")
