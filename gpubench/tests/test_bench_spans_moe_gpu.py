"""On the card, ``qwen2moe.prefill_16x512``'s smoke stretch profiled as a
traced run profiles it (``test_bench_spans_gpu._profiled``): with the
MoE stage readers, the span metrics and ``repro_torch.lowbit_kernel``'s
time add up to the stretch's kernel time, and the expert stage launches
three grouped GeMMs for the routed experts and the shared expert's three,
a layer."""

from __future__ import annotations

import pytest

from smoke import smoke, smoke_cell
from gpubench import harness, spans
from test_bench_spans_gpu import PARTS, _profiled, card  # noqa: F401  (card: a fixture)

pytestmark = pytest.mark.gpu

CELL = "qwen2moe.prefill_16x512"
MOE_PARTS = ("moe_route_ms", "moe_dispatch_ms", "moe_experts_ms", "moe_combine_ms")


def test_moe_spans_close_the_sum(card, monkeypatch):
    cell = smoke_cell(CELL)
    trace, _ = _profiled(cell, card, monkeypatch)
    suffix = smoke(CELL)["suffix"]
    total = spans.of(trace).kernel_s * 1e3 / trace.units
    lowbit = spans.device_ms(trace, spans.PREFIX + "lowbit_kernel")
    parts = [harness.metric_reader(f"{m}.{suffix}").read(trace) for m in PARTS + MOE_PARTS]
    assert all(parts[len(PARTS):])
    assert sum(p for p in parts if p is not None) + lowbit == pytest.approx(total, rel=5e-3)
    gemms = harness.metric_reader(f"expert_gemms_per_step.{suffix}").read(trace)
    cfg = cell.config
    assert gemms == cfg["num_layers"] * 3 * 2
    idle = harness.metric_reader(f"moe_idle_ms.{suffix}").read(trace)
    # the window's idle time a unit, scaled by the MoE spans' share: within a unit's wall
    assert 0 <= idle <= trace.unit_wall_s * 1e3
