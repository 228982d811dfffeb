"""Catalog of every metric name the port may emit, and a snapshot
checker (``python -m repro_torch.obs --check``).

The catalog is the contract between instrumentation sites and
consumers: adding a metric means adding its row here, or ``--check``
fails with an "unregistered metric" finding.  Label sets are checked
too, so a call site cannot silently grow a new cardinality dimension.

Counterpart of ``repro/obs/catalog.py``: the reference's names, types
and labels, less three that the port does not register —

* ``repro_qmm_traces_total`` and ``repro_qconv_traces_total``: they
  count ``jax.jit`` traces, and PyTorch runs eagerly (nothing traces);
* ``repro_kernel_fallback_total``: the port has no fallback chain, a
  failed CUDA launch raises (``kernels/ops.py``).

So every port snapshot passes the reference's checker too.
"""

from __future__ import annotations

from typing import Dict, List

__all__ = ["CATALOG", "check_snapshot"]

# name -> {"type": counter|gauge|histogram, "labels": (...), "help": str}
CATALOG: Dict[str, Dict] = {
    # ---- kernel dispatch layer (process registry) ----
    "repro_qmm_dispatch_total": {
        "type": "counter", "labels": ("mode", "backend", "layout"),
        "help": "qmm host-side dispatches by (mode, backend, layout)"},
    "repro_qconv_dispatch_total": {
        "type": "counter", "labels": ("mode", "backend", "layout"),
        "help": "qconv host-side dispatches by (mode, backend, layout)"},
    # ---- autotune layer (process registry) ----
    "repro_tune_plan_lookups_total": {
        "type": "counter", "labels": ("result",),
        "help": "plan_for cache lookups by result (hit | default)"},
    "repro_tune_plan_resolve_seconds": {
        "type": "histogram", "labels": (),
        "help": "plan_for resolution latency (pure lookup, no measuring)"},
    "repro_tune_ensure_total": {
        "type": "counter", "labels": ("result",),
        "help": "ensure_plan outcomes by result (hit | measured)"},
    "repro_tune_measure_seconds": {
        "type": "histogram", "labels": (),
        "help": "on-device candidate measurement latency per ensure_plan"},
    # ---- resilience plane (process registry) ----
    "repro_faults_injected_total": {
        "type": "counter", "labels": ("point",),
        "help": "deterministic fault injections fired, by injection point"},
    "repro_tune_contained_total": {
        "type": "counter", "labels": ("site",),
        "help": "tuner/plan-cache failures contained to defaults, by site"},
    # ---- mesh / sharded path (process registry) ----
    "repro_mesh_psum_total": {
        "type": "counter", "labels": ("mode", "acc_dtype"),
        "help": "integer psum reductions issued by qmm_sharded"},
    "repro_mesh_psum_wire_bytes_total": {
        "type": "counter", "labels": ("mode",),
        "help": "bytes moved per device by qmm_sharded psum reductions"},
    # ---- serving engine (per-engine registry) ----
    "repro_engine_steps_total": {
        "type": "counter", "labels": (),
        "help": "scheduler ticks executed"},
    "repro_engine_admissions_total": {
        "type": "counter", "labels": (),
        "help": "requests admitted from queue into a slot"},
    "repro_engine_evictions_total": {
        "type": "counter", "labels": ("cause",),
        "help": "slot evictions by cause (done | expired | cancelled | "
                "numeric_error | error)"},
    "repro_engine_queue_drops_total": {
        "type": "counter", "labels": ("cause",),
        "help": "requests resolved without a slot (expired | cancelled | "
                "rejected)"},
    "repro_engine_preemptions_total": {
        "type": "counter", "labels": ("cause",),
        "help": "slot preemptions returned to queue, by cause"},
    "repro_engine_step_errors_total": {
        "type": "counter", "labels": (),
        "help": "scheduler steps that raised and were quarantined"},
    "repro_engine_queue_depth": {
        "type": "gauge", "labels": (),
        "help": "queued (unadmitted) requests after the latest tick"},
    "repro_engine_live_slots": {
        "type": "gauge", "labels": (),
        "help": "occupied slots after the latest tick"},
    "repro_engine_prefill_tokens_total": {
        "type": "counter", "labels": (),
        "help": "prompt tokens consumed by prefill (chunked or bucketed)"},
    "repro_engine_decode_tokens_total": {
        "type": "counter", "labels": (),
        "help": "tokens produced by decode steps (excludes prefill's first)"},
    "repro_engine_ttft_seconds": {
        "type": "histogram", "labels": (),
        "help": "submit -> first token latency per request"},
    "repro_engine_inter_token_seconds": {
        "type": "histogram", "labels": (),
        "help": "latency between consecutive tokens of one stream"},
    "repro_engine_page_pool_used": {
        "type": "gauge", "labels": ("entry",),
        "help": "pages in use per KV cache entry (paged engines)"},
    "repro_engine_page_pool_high_water": {
        "type": "gauge", "labels": ("entry",),
        "help": "max pages ever in use per KV cache entry"},
    "repro_engine_kv_cache_bytes": {
        "type": "gauge", "labels": ("kind",),
        "help": "KV cache footprint (kind=packed | dense_equiv)"},
}


def check_snapshot(snapshot: Dict) -> List[str]:
    """Findings (empty = ok) for one registry snapshot dict."""
    findings: List[str] = []
    if not isinstance(snapshot, dict):
        return ["snapshot is not a JSON object"]
    schema = snapshot.get("schema")
    if schema != 1:
        findings.append(f"unknown snapshot schema {schema!r} (expected 1)")
    metrics = snapshot.get("metrics")
    if not isinstance(metrics, dict):
        return findings + ["snapshot has no 'metrics' object"]
    for name, m in metrics.items():
        spec = CATALOG.get(name)
        if spec is None:
            findings.append(f"unregistered metric name {name!r}")
            continue
        if m.get("type") != spec["type"]:
            findings.append(f"{name}: type {m.get('type')!r} != catalog "
                            f"{spec['type']!r}")
        if tuple(m.get("labels", ())) != tuple(spec["labels"]):
            findings.append(f"{name}: labels {tuple(m.get('labels', ()))!r}"
                            f" != catalog {tuple(spec['labels'])!r}")
        for s in m.get("series", ()):
            got = tuple(sorted(s.get("labels", {})))
            if got != tuple(sorted(spec["labels"])):
                findings.append(f"{name}: series labels {got!r} != "
                                f"catalog {tuple(sorted(spec['labels']))!r}")
    return findings
