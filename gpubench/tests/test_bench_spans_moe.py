"""The MoE readers (``moe_*_ms``, ``moe_idle_ms``, ``expert_gemms_per_step``)
on a synthetic prefill trace: each stage span claims the kernels it
launched innermost, the expert GeMMs and idle gaps count at any depth
below their span, and with the other span readers and
``repro_torch.lowbit_kernel``'s time they add up to the kernel time."""

from __future__ import annotations

import pytest

from smoke import ROOT  # noqa: F401  (puts the checkout on sys.path)
from gpubench import harness, spans

P = spans.PREFIX
PARTS = ("quant_ms", "ssd_ms", "wpack_ms", "ste_bwd_ms", "optim_ms", "entry_ms", "other_ms",
         "moe_route_ms", "moe_dispatch_ms", "moe_experts_ms", "moe_combine_ms")
MOE = ("moe_route_ms", "moe_dispatch_ms", "moe_experts_ms", "moe_combine_ms", "moe_idle_ms",
       "expert_gemms_per_step")


def _prefill_trace(units: int = 1) -> harness.Trace:
    """One MoE layer of a prefill: attention's projection, then route,
    dispatch, two expert GeMMs (each a qmm with its quantize and kernel)
    and combine; one kernel launched in each place, 1 s after its
    launch, seconds 1 .. 10 by place."""
    host = [("gpubench.prefill.forward", 0.0, 200.0), (P + "prefill", 1.0, 199.0),
            (P + "qmm", 2.0, 20.0), (P + "quantize", 3.0, 6.0), (P + "lowbit_kernel", 7.0, 9.0),
            (P + "moe.route", 30.0, 40.0), (P + "moe.dispatch", 41.0, 50.0),
            (P + "moe.experts", 51.0, 120.0),
            (P + "qmm", 52.0, 80.0), (P + "quantize", 53.0, 60.0),
            (P + "lowbit_kernel", 61.0, 70.0),
            (P + "qmm", 81.0, 110.0), (P + "lowbit_kernel", 90.0, 100.0),
            (P + "moe.combine", 121.0, 130.0)]
    places = [(4.0, "reduce_kernel", 1.0), (8.0, "lowbit_gemm_kernel", 2.0),
              (31.0, "softmax_kernel", 3.0), (42.0, "sort_kernel", 4.0),
              (55.0, "elementwise_kernel", 5.0), (62.0, "lowbit_gemm_kernel", 6.0),
              (95.0, "lowbit_gemm_kernel", 7.0), (112.0, "silu_kernel", 8.0),
              (122.0, "mul_kernel", 9.0), (150.0, "rms_norm", 10.0)]
    dev = []
    for launch, name, length in places:
        host.append(("cudaLaunchKernel", launch, launch + 0.01))
        dev.append((name, launch + 1.0, launch + 1.0 + length))
    # the window: 100 s of wall time a unit
    return harness.Trace(units, 100.0, dev, host, 1.0, {}, 0)


@pytest.mark.parametrize("units", [1, 2])
def test_readers_and_the_sum_that_closes(units):
    tr = _prefill_trace(units)
    ms = 1e3 / units
    got = {n: harness.metric_reader(f"{n}.moe_prefill").read(tr) for n in MOE}
    # idle gaps begin at each kernel's end: 6 and 11 outside the MoE spans,
    # 35 in route, 47 in dispatch, 61, 69 and 103 in experts at depth (its
    # qmm, quantize and kernel spans), 121 at combine's start, 132 past it
    gaps_moe = (43 - 35) + (56 - 47) + (63 - 61) + (96 - 69) + (113 - 103) + (123 - 121)
    gaps_all = gaps_moe + (9 - 6) + (32 - 11) + (151 - 132)
    # the window's idle time a unit: its wall time less the busy time a unit
    window_idle = tr.unit_wall_s - tr.busy_s / units
    # the kernel launched at 55 is quantize's (inside an expert's qmm)
    assert got == {"moe_route_ms": 3 * ms, "moe_dispatch_ms": 4 * ms,
                   "moe_experts_ms": 8 * ms, "moe_combine_ms": 9 * ms,
                   "moe_idle_ms": pytest.approx(gaps_moe / gaps_all * window_idle * 1e3),
                   "expert_gemms_per_step": 2 / units}
    parts = [harness.metric_reader(f"{n}.moe_prefill").read(tr) for n in PARTS]
    lowbit = spans.device_ms(tr, P + "lowbit_kernel")
    assert lowbit == pytest.approx((2 + 6 + 7) * ms)
    assert sum(p for p in parts if p is not None) + lowbit == pytest.approx(
        spans.of(tr).kernel_s * ms)


@pytest.mark.parametrize("name", MOE)
def test_reader_finds_nothing_without_moe_spans(name):
    reader = harness.metric_reader(f"{name}.moe_prefill")
    assert reader.read(harness.Trace(1, 1.0, [], [], 0.0, {}, 0)) is None
    # the parent's trace of a prefill: program spans, none of the MoE's
    plain = harness.Trace(1, 1.0, [("add_kernel", 1.0, 2.0), ("mul_kernel", 4.0, 5.0)],
                          [(P + "prefill", 0.0, 6.0), (P + "lowbit_kernel", 0.2, 0.3),
                           ("cudaLaunchKernel", 0.5, 0.6), ("cudaLaunchKernel", 3.5, 3.6)],
                          6.0, {}, 0)
    assert reader.read(plain) is None
