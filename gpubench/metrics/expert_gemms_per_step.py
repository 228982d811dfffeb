"""GeMM launches per unit inside the MoE layer's expert stage: how often
``repro_torch.lowbit_kernel`` opened within ``repro_torch.moe.experts``
at any depth (a layer: three grouped launches for the routed experts,
gate, up and down over every expert's rows, and three for the shared
expert)."""

from gpubench import spans


def read(trace):
    experts = [h for h in trace.host_ops if h[0] == "repro_torch.moe.experts"]
    if not experts:
        return None
    launches = [s for name, s, _ in trace.host_ops if name == "repro_torch.lowbit_kernel"]
    calls = sum(i >= 0 for i in spans.innermost(experts, launches))
    return calls / trace.units
