"""Per-engine serving telemetry: the instrument bundle + event sink the
Engine/scheduler pair records into.

Counterpart of ``repro/serving/metrics.py``, host Python on the port's
:mod:`repro_torch.obs`.  One :class:`EngineMetrics` per
:class:`~repro_torch.serving.engine.Engine`: a private
:class:`~repro_torch.obs.MetricsRegistry` (so two engines never mix
series) plus the engine's JSONL :class:`~repro_torch.obs.EventLog`.  The
scheduler calls the ``on_*`` hooks at its lifecycle edges; every hook
early-returns when obs is disabled, so an instrumented tick under
``REPRO_OBS=off`` costs one attribute lookup per hook.

Reconciliation contracts, exact by construction:

* ``repro_engine_ttft_seconds`` count     == results with >= 1 token;
* ``repro_engine_decode_tokens_total``    == sum(len(r.tokens)) minus
  the first (prefill-produced) token of each such result;
* evictions + queue drops (by cause)      == total results;
* ``repro_engine_page_pool_high_water``   == ``page_stats()``'s
  ``high_water`` (the allocator tracks it at alloc time; the gauge
  mirrors it per tick).
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, Optional

from repro_torch import obs

__all__ = ["EngineMetrics"]

_ENGINE_IDS = itertools.count()


class EngineMetrics:
    """Instrument bundle + event log for one engine."""

    def __init__(self, events_path: Optional[str] = None,
                 engine_id: Optional[str] = None):
        self.engine_id = engine_id or f"e{next(_ENGINE_IDS)}"
        self.registry = obs.MetricsRegistry()
        self.events = obs.EventLog(
            path=(obs.default_events_path() if events_path is None
                  else events_path),
            engine=self.engine_id)
        r = self.registry
        self.steps = r.counter(
            "repro_engine_steps_total", "scheduler ticks executed")
        self.admissions = r.counter(
            "repro_engine_admissions_total",
            "requests admitted from queue into a slot")
        self.evictions = r.counter(
            "repro_engine_evictions_total",
            "slot evictions by cause (done | expired | cancelled | "
            "numeric_error | error)",
            labels=("cause",))
        self.queue_drops = r.counter(
            "repro_engine_queue_drops_total",
            "requests resolved without a slot (expired | cancelled | "
            "rejected)",
            labels=("cause",))
        self.preemptions = r.counter(
            "repro_engine_preemptions_total",
            "slot preemptions returned to queue, by cause",
            labels=("cause",))
        self.step_errors = r.counter(
            "repro_engine_step_errors_total",
            "scheduler steps that raised and were quarantined")
        self.queue_depth = r.gauge(
            "repro_engine_queue_depth",
            "queued (unadmitted) requests after the latest tick")
        self.live_slots = r.gauge(
            "repro_engine_live_slots", "occupied slots after the latest tick")
        self.prefill_tokens = r.counter(
            "repro_engine_prefill_tokens_total",
            "prompt tokens consumed by prefill (chunked or bucketed)")
        self.decode_tokens = r.counter(
            "repro_engine_decode_tokens_total",
            "tokens produced by decode steps (excludes prefill's first)")
        self.ttft = r.histogram(
            "repro_engine_ttft_seconds",
            "submit -> first token latency per request")
        self.itl = r.histogram(
            "repro_engine_inter_token_seconds",
            "latency between consecutive tokens of one stream")
        self.page_used = r.gauge(
            "repro_engine_page_pool_used",
            "pages in use per KV cache entry (paged engines)",
            labels=("entry",))
        self.page_high = r.gauge(
            "repro_engine_page_pool_high_water",
            "max pages ever in use per KV cache entry", labels=("entry",))
        self.kv_bytes = r.gauge(
            "repro_engine_kv_cache_bytes",
            "KV cache footprint (kind=packed | dense_equiv)",
            labels=("kind",))
        # Latency bookkeeping, keyed by request uid (uids outlive slot
        # reassignment, so an evict-and-refill tick cannot cross streams).
        self._submit_ts: Dict[int, float] = {}
        self._last_tok_ts: Dict[int, float] = {}

    @property
    def enabled(self) -> bool:
        return self.registry.enabled

    # ------------------------------------------------- lifecycle hooks

    def on_submit(self, uid: int) -> None:
        if not self.enabled:
            return
        self._submit_ts[uid] = time.perf_counter()

    def on_admit(self, uid: int) -> None:
        if not self.enabled:
            return
        self.admissions.inc()
        self.events.emit("admit", uid=uid)

    def on_first_token(self, uid: int) -> None:
        """Prefill produced the stream's first token (TTFT edge)."""
        if not self.enabled:
            return
        now = time.perf_counter()
        self.ttft.observe(now - self._submit_ts.pop(uid, now))
        self._last_tok_ts[uid] = now

    def on_decode_token(self, uid: int) -> None:
        if not self.enabled:
            return
        now = time.perf_counter()
        self.decode_tokens.inc()
        self.itl.observe(now - self._last_tok_ts.get(uid, now))
        self._last_tok_ts[uid] = now

    def on_prefill_tokens(self, n: int) -> None:
        if not self.enabled:
            return
        self.prefill_tokens.inc(n)

    def on_finish(self, uid: int, status: str, n_tokens: int) -> None:
        """A slot-holding request resolved (cause: done when it ran to
        completion, else the eviction status)."""
        if not self.enabled:
            return
        cause = "done" if status == "ok" else status
        self.evictions.inc(cause=cause)
        self.events.emit("finish", uid=uid, status=status,
                         n_tokens=n_tokens)
        self._submit_ts.pop(uid, None)
        self._last_tok_ts.pop(uid, None)

    def on_queue_drop(self, uid: int, status: str) -> None:
        """A request resolved while still queued (never held a slot)."""
        if not self.enabled:
            return
        self.queue_drops.inc(cause=status)
        self.events.emit("queue_drop", uid=uid, status=status)
        self._submit_ts.pop(uid, None)

    def on_preempt(self, uid: int, cause: str, retries: int,
                   delay_s: float) -> None:
        """A slot-holding request was bumped back to the queue (pages
        reclaimed); it retries after ``delay_s`` on the engine clock."""
        if not self.enabled:
            return
        self.preemptions.inc(cause=cause)
        self.events.emit("preempt", uid=uid, cause=cause,
                         retries=retries, delay_s=round(delay_s, 6))
        # TTFT keeps measuring from the ORIGINAL submit; a preempted
        # request's first token really did take that long to arrive.

    def on_step_error(self, exc: BaseException, in_flight: int) -> None:
        """A scheduler step raised; in-flight requests are being
        quarantined to status "error" by the caller."""
        if not self.enabled:
            return
        self.step_errors.inc()
        self.events.emit("step_error", error=type(exc).__name__,
                         detail=str(exc)[:200], in_flight=in_flight)

    def tick(self, queue_depth: int, live: int, page_stats=()) -> None:
        """Per-step rollup: occupancy gauges + page-pool mirror."""
        if not self.enabled:
            return
        self.steps.inc()
        self.queue_depth.set(queue_depth)
        self.live_slots.set(live)
        for i, s in enumerate(page_stats):
            if s is None:
                continue
            self.page_used.set(s["used"], entry=str(i))
            self.page_high.set(s["high_water"], entry=str(i))

    def set_kv_bytes(self, packed: int, dense_equiv: int) -> None:
        if not self.enabled:
            return
        self.kv_bytes.set(packed, kind="packed")
        self.kv_bytes.set(dense_equiv, kind="dense_equiv")

    # ---------------------------------------------------------- export

    def snapshot(self) -> Dict:
        return self.registry.snapshot()

    def close(self) -> None:
        self.events.close()
