"""``gpubench/spans.py`` and the span readers on synthetic events: the
innermost program span open at a kernel's launch claims it, a kernel
launched from a second thread inside no span of its own falls to the
span open on the main thread, idle gaps count where they began, and
kernels found no launch for count in ``other_ms``."""

from __future__ import annotations

import pytest

from smoke import ROOT  # noqa: F401  (puts the checkout on sys.path)
from gpubench import harness, spans

P = spans.PREFIX
READERS = ("quant_ms", "ssd_ms", "wpack_ms", "wpacks_per_step", "ste_bwd_ms", "optim_ms",
           "entry_ms", "other_ms")


def _step_trace(units: int = 1) -> harness.Trace:
    """One QAT-like unit: every span of the step, one kernel launched in
    each place, kernel seconds 1 .. 11 by place; the last launch is in no
    program span."""
    host = [("gpubench.train.step", 0.0, 100.0), (P + "train.step", 1.0, 99.0),
            (P + "train.forward", 2.0, 40.0), (P + "weight_pack", 3.0, 6.0),
            (P + "qmm", 7.0, 20.0), (P + "quantize", 9.0, 12.0),
            (P + "lowbit_kernel", 13.0, 15.0), (P + "ssd", 21.0, 30.0),
            (P + "train.backward", 41.0, 80.0), (P + "ste_backward", 45.0, 50.0),
            (P + "train.optimizer", 81.0, 90.0)]
    places = [(4.0, "elementwise_kernel", 1.0), (8.0, "copy_kernel", 2.0),
              (10.0, "reduce_kernel", 3.0), (14.0, "lowbit_gemm_kernel", 4.0),
              (22.0, "cumsum_kernel", 5.0), (35.0, "rms_norm", 6.0),
              (46.0, "sm80_xmma_gemm", 7.0), (55.0, "mul_kernel", 8.0),
              (82.0, "adam_kernel", 9.0), (95.0, "add_kernel", 10.0),
              (99.5, "fill_kernel", 11.0)]
    dev, t = [], 0.0
    for launch, name, length in places:
        host.append(("cudaLaunchKernel", launch, launch + 0.01))
        start = max(t, launch + 0.5)
        dev.append((name, start, start + length))
        t = start + length
    return harness.Trace(units, 1.0, dev, host, 1.0, {}, 0)


def test_innermost_span_claims_the_kernel():
    got = spans.from_trace(_step_trace()).by_name
    want = {"weight_pack": 1.0, "qmm": 2.0, "quantize": 3.0, "lowbit_kernel": 4.0, "ssd": 5.0,
            "train.forward": 6.0, "ste_backward": 7.0, "train.backward": 8.0,
            "train.optimizer": 9.0, "train.step": 10.0}
    assert {k: got[P + k].device_s for k in want} == want
    assert got[spans.NONE].device_s == 11.0 and got[spans.NONE].kernels == 1
    assert got[P + "qmm"].calls == 1 and got[P + "qmm"].host_s == 13.0


def test_main_thread_span_claims_a_second_threads_launch():
    # the main thread waits in train.backward; the engine's thread opens
    # ste_backward for one projection, and launches a kernel outside it
    sp = [(P + "train.backward", 10.0, 50.0), (P + "ste_backward", 20.0, 30.0)]
    kernels = [("gemm", 60.0, 61.0, 25.0), ("sum", 61.0, 63.0, 35.0), ("late", 63.0, 67.0, 55.0)]
    got = spans.attribute(sp, kernels)
    assert got[P + "ste_backward"].device_s == 1.0
    assert got[P + "train.backward"].device_s == 2.0
    assert got[spans.NONE].device_s == 4.0


def test_idle_gaps_count_where_they_began():
    sp = [(P + "prefill", 0.0, 10.0), (P + "ssd", 2.0, 4.0)]
    got = spans.attribute(sp, [], gaps=[(3.0, 0.25), (5.0, 0.5), (12.0, 1.0)])
    assert (got[P + "ssd"].idle_s, got[P + "prefill"].idle_s, got[spans.NONE].idle_s) == \
        (0.25, 0.5, 1.0)


def test_link_pairs_from_the_last():
    assert spans.link([1.0, 2.0], [5.0, 6.0]) == [1.0, 2.0]
    # the profiler lost the first kernel's record: its launch pairs with none
    assert spans.link([0.1, 0.5, 2.0], [1.0, 2.5]) == [0.5, 2.0]
    # a kernel with no launch in the trace is one of the first
    assert spans.link([0.5, 2.0], [0.2, 1.0, 2.5]) == [None, 0.5, 2.0]


def test_nested_cu_launch_is_one_launch():
    host = [("cudaLaunchKernel", 1.0, 1.5), ("cuLaunchKernel", 1.1, 1.4),
            ("cuLaunchKernelEx", 2.0, 2.1), ("cudaMemcpyAsync", 3.0, 3.1)]
    assert spans._launch_times(host) == [1.0, 2.0]


def test_unlinked_kernels_count_in_other_ms():
    host = [(P + "prefill", 0.0, 10.0), (P + "quantize", 1.0, 2.0),
            ("cudaLaunchKernel", 1.5, 1.6), ("cudaLaunchKernel", 5.0, 5.1)]
    dev = [("orphan_kernel", 0.5, 1.0), ("reduce_kernel", 3.0, 4.0),
           ("add_kernel", 5.5, 7.5)]
    tr = harness.Trace(1, 1.0, dev, host, 1.0, {}, 0)
    sp = spans.from_trace(tr)
    assert (sp.unlinked, sp.unlinked_s) == (1, 0.5)
    read = {name: harness.metric_reader(f"{name}.prefill").read(tr)
            for name in ("quant_ms", "other_ms")}
    assert read == {"quant_ms": 1000.0, "other_ms": 2500.0}


@pytest.mark.parametrize("units", [1, 4])
def test_readers_and_the_sum_that_closes(units):
    tr = _step_trace(units)
    got = {name: harness.metric_reader(f"{name}.train").read(tr) for name in READERS}
    ms = 1e3 / units
    assert got == {"quant_ms": 3 * ms, "ssd_ms": 5 * ms, "wpack_ms": 1 * ms,
                   "wpacks_per_step": 1 / units, "ste_bwd_ms": 7 * ms, "optim_ms": 9 * ms,
                   "entry_ms": 2 * ms, "other_ms": (6 + 8 + 10 + 11) * ms}
    lowbit = spans.device_ms(tr, P + "lowbit_kernel")
    parts = sum(v for k, v in got.items() if k != "wpacks_per_step") + lowbit
    assert parts == pytest.approx(spans.of(tr).kernel_s * ms)
    assert lowbit == pytest.approx(tr.kernel_s(harness.is_port_kernel) * ms)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_in_an_empty_or_span_free_trace(name):
    reader = harness.metric_reader(f"{name}.train")
    assert reader.read(harness.Trace(1, 1.0, [], [], 0.0, {}, 0)) is None
    # the parent's trace: kernels and launches, no program span
    plain = harness.Trace(1, 1.0, [("add_kernel", 1.0, 2.0)],
                          [("gpubench.train.step", 0.0, 3.0),
                           ("cudaLaunchKernel", 0.5, 0.6)], 3.0, {}, 0)
    assert reader.read(plain) is None
