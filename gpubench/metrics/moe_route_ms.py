"""Device ms per unit in the MoE layer's route stage: kernels launched
inside ``repro_torch.moe.route`` (the router's product, softmax and top-k)."""

from gpubench import spans


def read(trace):
    return spans.device_ms(trace, "repro_torch.moe.route")
