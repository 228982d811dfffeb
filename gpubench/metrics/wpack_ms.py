"""Device ms per unit in weight packing at run time: kernels launched
inside ``repro_torch.weight_pack`` (``QTensor.from_dense``; a QAT step
packs its master weights on every forward)."""

from gpubench import spans


def read(trace):
    return spans.device_ms(trace, "repro_torch.weight_pack")
