"""Device time by program span: each kernel of the profiled stretch
belongs to the innermost program span (``repro_torch.*``, the port's
``obs.annotate`` regions) open when it was launched.

Nothing here imports the program.  A :class:`~gpubench.harness.Trace`
holds the profiler's host events and device operations as (name, start
s, end s) on one clock, without the profiler's link from a kernel to
its launch, so the link is made again from order: the port runs on one
CUDA stream, where kernels run in the order they were launched, so the
kernel launches on the host (any thread, in time order) and the kernels
on the device pair off in order (:func:`link`).  A kernel with no
launch in the trace counts as unlinked.

A kernel launched by the autograd engine's device thread, inside no
program span of its own, falls to the span open on the main thread then
(``repro_torch.train.backward``): host spans are matched by time, over
every thread.  Each device-idle gap counts under the innermost program
span open when it began.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

PREFIX = "repro_torch."
# the CUDA calls (runtime ``cuda*``, low-level ``cu*``) that launch one kernel each
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel",
            "cuLaunchCooperativeKernel")
# spans that hold a unit's or a phase's own glue: what ``other_ms`` counts
UNIT_SPANS = ("repro_torch.cnn.forward", "repro_torch.prefill", "repro_torch.train.step",
              "repro_torch.train.forward", "repro_torch.train.backward")
# the name kernels with no program span, or no launch, are summed under
NONE = "(none)"


@dataclasses.dataclass
class SpanTotals:
    """One span name over the stretch: how often it opened, its host
    seconds, the device seconds and number of the kernels it launched
    innermost, and the device-idle seconds that began inside it."""
    calls: int = 0
    host_s: float = 0.0
    device_s: float = 0.0
    kernels: int = 0
    idle_s: float = 0.0


def innermost(spans: Sequence[Tuple[str, float, float]], times: Sequence[float]
              ) -> List[int]:
    """For each time, the index in ``spans`` of the span open then that
    began last (-1: none), by one sweep in time order."""
    order = sorted(range(len(spans)), key=lambda i: spans[i][1])
    by_time = sorted(range(len(times)), key=lambda j: times[j])
    out = [-1] * len(times)
    heap: List[Tuple[float, int]] = []       # (-start, index) of spans begun so far
    k = 0
    for j in by_time:
        t = times[j]
        while k < len(order) and spans[order[k]][1] <= t:
            heapq.heappush(heap, (-spans[order[k]][1], order[k]))
            k += 1
        while heap and spans[heap[0][1]][2] < t:
            heapq.heappop(heap)               # ended before t, so before every later time
        out[j] = heap[0][1] if heap else -1
    return out


def link(launches: Sequence[float], kernel_starts: Sequence[float]) -> List[Optional[float]]:
    """The launch time of each kernel (both in time order), paired from
    the last: the i-th last launch is the i-th last kernel's.  The
    profiler drops the records of the first kernels a session sees (up
    to six of a QAT step's first, on an H100 with torch 2.11), never
    later ones, so where the counts differ the first launches have no
    kernel; where kernels outnumber launches the first kernels have no
    launch (None)."""
    n, m = len(launches), len(kernel_starts)
    if n >= m:
        return list(launches[n - m:])
    return [None] * (m - n) + list(launches)


def attribute(spans: Sequence[Tuple[str, float, float]],
              kernels: Sequence[Tuple[str, float, float, Optional[float]]],
              gaps: Sequence[Tuple[float, float]] = ()) -> Dict[str, SpanTotals]:
    """Totals by span name.  ``spans``: (name, start, end) of the program
    spans on the host; ``kernels``: (name, start, end, launch time or
    None) on the device; ``gaps``: (start, length) of the device's idle
    gaps.  Kernels launched in no span, or unlinked, and gaps begun in no
    span count under :data:`NONE`."""
    out: Dict[str, SpanTotals] = {}
    for name, start, end in spans:
        tot = out.setdefault(name, SpanTotals())
        tot.calls += 1
        tot.host_s += end - start
    linked = [k for k in kernels if k[3] is not None]
    owner = innermost(spans, [k[3] for k in linked])
    for (_, start, end, _), i in zip(linked, owner):
        tot = out.setdefault(spans[i][0] if i >= 0 else NONE, SpanTotals())
        tot.device_s += end - start
        tot.kernels += 1
    none = out.setdefault(NONE, SpanTotals())
    for _, start, end, launch in kernels:
        if launch is None:
            none.device_s += end - start
            none.kernels += 1
    for (_, length), i in zip(gaps, innermost(spans, [g[0] for g in gaps])):
        out.setdefault(spans[i][0] if i >= 0 else NONE, SpanTotals()).idle_s += length
    return out


@dataclasses.dataclass
class TraceSpans:
    """A trace's totals by span name, its kernel seconds, and the kernels
    found no launch for (count, seconds)."""
    by_name: Dict[str, SpanTotals]
    kernel_s: float
    unlinked: int
    unlinked_s: float

    def get(self, name: str) -> SpanTotals:
        return self.by_name.get(name, SpanTotals())

    @property
    def found(self) -> bool:
        """Whether the program opened any span in the trace."""
        return any(name.startswith(PREFIX) for name in self.by_name)


def _launch_times(host_ops) -> List[float]:
    """Start times of the kernel launches in time order; a launch inside
    another (a runtime call's nested ``cu*`` call) is the same launch."""
    out: List[float] = []
    end = float("-inf")
    for _, start, stop in sorted((h for h in host_ops if h[0].startswith(LAUNCHES)),
                                 key=lambda h: h[1]):
        if start >= end:
            out.append(start)
            end = stop
    return out


def from_trace(trace) -> TraceSpans:
    spans = [h for h in trace.host_ops if h[0].startswith(PREFIX)]
    kernels = sorted(trace.kernels, key=lambda k: k[1])
    launches = link(_launch_times(trace.host_ops), [k[1] for k in kernels])
    busy = trace.busy_intervals()
    gaps = [(e0, s1 - e0) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    by_name = attribute(spans, [k + (t,) for k, t in zip(kernels, launches)], gaps)
    lost = [k for k, t in zip(kernels, launches) if t is None]
    return TraceSpans(by_name=by_name, kernel_s=sum(e - s for _, s, e in kernels),
                      unlinked=len(lost), unlinked_s=sum(e - s for _, s, e in lost))


_last: list = [None, None]      # the last trace read and its spans: one pass serves every reader


def of(trace) -> TraceSpans:
    """:func:`from_trace` of ``trace``, computed once for the readers of
    one run."""
    if _last[0] is not trace:
        _last[:] = [trace, from_trace(trace)]
    return _last[1]


def device_ms(trace, *names: str) -> Optional[float]:
    """Device ms per unit of the kernels the spans ``names`` launched
    innermost; None when none of them opened in the trace."""
    sp = of(trace)
    if not any(sp.get(n).calls for n in names):
        return None
    return sum(sp.get(n).device_s for n in names) * 1e3 / trace.units
