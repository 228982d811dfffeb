"""On the card, one smoke-size stretch of each cell, profiled as a traced
run profiles it: the order in which ``gpubench/spans.py`` pairs launches
with kernels gives each span the device time the profiler's own links
give it; the port's kernels are all launched in
``repro_torch.lowbit_kernel``; the span metrics and that span add up to
the stretch's kernel time; the profiler links almost every kernel to a
launch; no program span's device-side range counts as a device
operation."""

from __future__ import annotations

import collections

import pytest

from smoke import CELLS, smoke, smoke_cell
from gpubench import harness, ranks, spans

pytestmark = pytest.mark.gpu

PARTS = ("quant_ms", "ssd_ms", "wpack_ms", "ste_bwd_ms", "optim_ms", "entry_ms", "other_ms")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    harness.set_cache_dirs()
    return torch.device("cuda", 0)


def _profiled(cell, device, monkeypatch):
    """The cell's traced stretch at smoke size (rank 0's, on as many cards
    as its smoke ranks): the harness's Trace, and the profiler session's
    events."""
    import torch
    import torch.profiler

    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"needs {cell.chips} CUDA devices")
    sessions = []

    class Keep(torch.profiler.profile):
        def __enter__(self):
            sessions.append(self)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "profile", Keep)
    drv = harness.load_module("drivers", cell.traffic["driver"])
    with ranks.lead(cell, 3000000201, device) as lead:
        run = drv.Run(cell, 3000000201, device)
        lead.built()
        first = getattr(run, "first_window_unit", lambda: 0)()
        for i in range(first, first + 2):
            lead.call(run, "step", i)
        units = run.units_for_trace()

        def stretch():
            lead.announce("stretch", first + 2, units)
            for i in range(first + 2, first + 2 + units):
                run.step(i)
        lead.settle("profile")
        trace = harness.profile(stretch, units, 1.0, run.work(), 0)
        lead.call(run, "release")
        lead.end()
    return trace, sessions[-1].events()


def _linked(events):
    """Device seconds by innermost program span from the profiler's own
    links (a kernel's correlation id is its launch's; the launch's
    thread's spans, else the main thread's), and the seconds of kernels
    with no launch."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    launch = {e.id: e for e in cpu if e.name.startswith(spans.LAUNCHES)}
    by_thread = collections.defaultdict(list)
    for e in cpu:
        if e.name.startswith(spans.PREFIX):
            by_thread[e.thread].append((e.name, e.time_range.start, e.time_range.end))
    main = next(e.thread for e in cpu if e.name in spans.UNIT_SPANS)
    out = collections.Counter()
    lost = 0.0
    for k in events:
        if (k.device_type != DeviceType.CUDA or getattr(k, "is_user_annotation", False)
                or k.name.startswith(("gpubench.", "Memcpy", "Memset", "memcpy", "memset"))):
            continue
        length = (k.time_range.end - k.time_range.start) * 1e-6
        if k.id not in launch:
            lost += length
            continue
        r = launch[k.id]
        own = by_thread[r.thread]
        (i,) = spans.innermost(own, [r.time_range.start])
        if i < 0 and r.thread != main:
            own = by_thread[main]
            (i,) = spans.innermost(own, [r.time_range.start])
        out[own[i][0] if i >= 0 else spans.NONE] += length
    return out, lost


@pytest.mark.parametrize("name", CELLS)
def test_spans_partition_the_kernels(card, name, monkeypatch):
    cell = smoke_cell(name)
    trace, events = _profiled(cell, card, monkeypatch)
    sp = spans.of(trace)
    total = sp.kernel_s
    assert total > 0
    assert not [op for op in trace.device_ops if op[0].startswith(spans.PREFIX)]
    for span, calls in smoke(name)["span_calls"].items():
        assert sp.get(spans.PREFIX + span).calls == calls * trace.units, span
    linked, lost = _linked(events)
    assert lost < 0.01 * total
    for span in set(linked) | set(sp.by_name):
        assert abs(sp.get(span).device_s - linked.get(span, 0.0)) <= 1e-3 * total, span
    lowbit = spans.device_ms(trace, spans.PREFIX + "lowbit_kernel")
    port = trace.kernel_s(harness.is_port_kernel) * 1e3 / trace.units
    assert abs(lowbit - port) <= 1e-3 * port
    parts = [harness.metric_reader(f"{m}.{smoke(name)['suffix']}").read(trace) for m in PARTS]
    assert sum(p for p in parts if p is not None) + lowbit == pytest.approx(
        total * 1e3 / trace.units, rel=5e-3)
