"""Weight packings per unit: how often ``repro_torch.weight_pack``
(``QTensor.from_dense``) opened."""

from gpubench import spans


def read(trace):
    calls = spans.of(trace).get("repro_torch.weight_pack").calls
    return calls / trace.units if calls else None
