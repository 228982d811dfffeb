"""Device ms per unit in the optimizer: kernels launched inside
``repro_torch.train.optimizer`` (AdamW: global norm, clip, moments,
update)."""

from gpubench import spans


def read(trace):
    return spans.device_ms(trace, "repro_torch.train.optimizer")
