"""Device ms per unit in the activation quantization of the port's entry
points: kernels launched inside ``repro_torch.quantize``
(``ops.quantize_activations``, ``conv_fused.conv_act_stats``: the
statistics, ternarize, pack)."""

from gpubench import spans


def read(trace):
    return spans.device_ms(trace, "repro_torch.quantize")
