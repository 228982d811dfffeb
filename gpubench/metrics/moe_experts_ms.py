"""Device ms per unit in the MoE layer's experts stage: kernels launched
inside ``repro_torch.moe.experts`` (every expert's products' own glue (SiLU, the gate-up product, casts, the rows read back from the experts' padded layout), the shared expert's too; the quantization and GeMM kernels inside keep their own spans)."""

from gpubench import spans


def read(trace):
    return spans.device_ms(trace, "repro_torch.moe.experts")
