"""Serving & kernel telemetry of the port: metrics registry, JSONL event
log, profiler trace annotations, and the ``python -m repro_torch.obs``
CLI.  Counterpart of ``repro/obs``; the names, environment variables,
snapshot and event schemas are the reference's (``catalog.py`` lists
the three metrics the port does not register).

Quick tour::

    from repro_torch import obs

    reg = obs.get_registry()                    # process-wide registry
    hits = reg.counter("my_hits_total", labels=("kind",))
    hits.inc(kind="warm")

    with obs.annotate("prefill_chunk"):         # torch.profiler region
        ...

    print(obs.to_prometheus(reg.snapshot()))

The spans the port opens (each kernel a span's code launches belongs to
the innermost one open at its launch):

* ``repro_torch.cnn.forward`` — ``PaperCNN.forward``, one batch;
* ``repro_torch.prefill`` — ``models.model.prefill``, one packed forward;
* ``repro_torch.train.step`` — one training step, with its phases
  ``repro_torch.train.forward`` (the loss), ``repro_torch.train.backward``
  (``torch.autograd.grad``, remat recompute included) and
  ``repro_torch.train.optimizer`` (``adamw.adamw_update``);
* ``repro_torch.qmm`` / ``repro_torch.qconv`` — the kernels' entry
  points (their own time: casts, scale vectors, plan lookup), holding
  ``repro_torch.quantize`` (``ops.quantize_activations``,
  ``conv_fused.conv_act_stats``: activation statistics, ternarize, pack)
  and ``repro_torch.lowbit_kernel`` (the hand-written kernels' launches,
  the conv's pack pass included);
* ``repro_torch.weight_pack`` — ``QTensor.from_dense``, weight packing at
  run time (the QAT forward packs its master weights per call);
* ``repro_torch.ssd`` — the Mamba2 mixer between ``in_proj`` and
  ``out_proj``: causal conv, chunked scan, gate and norm;
* ``repro_torch.ste_backward`` — the straight-through backward of a
  quantized projection (float32 products and the clip mask);
* ``repro_torch.moe.route`` / ``.dispatch`` / ``.experts`` / ``.combine``
  — ``models.moe.moe_ffn``'s stages: the router product, softmax and
  top-k; the sort by expert, the counts (their host read, dropless) and
  the row gather; every expert's products and glue, the shared expert's
  too (the ``qmm`` spans inside keep theirs); the weighted sum, the
  shared expert's gate and the aux loss.

The serving engine's regions keep the reference's names
(``decode_step``, ``prefill_chunk``, ``prefill_bucket``).

``REPRO_OBS=off`` hard-disables everything (record calls are single
attribute-lookup no-ops, event sinks never open); ``REPRO_OBS_EVENTS``
points engine event logs at a JSONL file; ``REPRO_OBS_SNAPSHOT`` makes
``write_snapshot_if_configured()`` dump the process registry on demand.
"""

from .registry import (ENV_OBS, SNAPSHOT_SCHEMA_VERSION, Counter, Gauge,
                       Histogram, MetricsRegistry, get_registry, obs_enabled,
                       set_enabled, to_prometheus)
from .events import (SCHEMA_VERSION, ENV_EVENTS, EventLog, run_id,
                     default_events_path, validate_line)
from .catalog import CATALOG, check_snapshot
from .trace import annotate

import json as _json
import os as _os

ENV_SNAPSHOT = "REPRO_OBS_SNAPSHOT"

__all__ = [
    "ENV_OBS", "ENV_EVENTS", "ENV_SNAPSHOT", "SNAPSHOT_SCHEMA_VERSION",
    "SCHEMA_VERSION", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "obs_enabled", "set_enabled", "to_prometheus",
    "EventLog", "run_id", "default_events_path", "validate_line",
    "CATALOG", "check_snapshot", "annotate",
    "write_snapshot_if_configured",
]


def write_snapshot_if_configured(registry=None):
    """Dump ``registry.snapshot()`` (default: process registry) to the
    path in ``REPRO_OBS_SNAPSHOT``; no-op when unset or obs is off.
    Returns the path written, or None."""
    path = _os.environ.get(ENV_SNAPSHOT, "").strip()
    if not path or not obs_enabled():
        return None
    snap = (registry or get_registry()).snapshot()
    with open(path, "w", encoding="utf-8") as fh:
        _json.dump(snap, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path
