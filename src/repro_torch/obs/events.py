"""Structured JSON-lines event log for the serving path.

Each record is one JSON object per line with a fixed envelope::

    {"schema": 1, "seq": 3, "ts": 12.345678, "run": "a1b2c3d4",
     "engine": "e0", "kind": "admit", ...event fields...}

* ``schema`` — :data:`SCHEMA_VERSION`; bump on envelope changes;
* ``seq`` — per-sink monotonic sequence number (gap-free while open);
* ``ts`` — monotonic seconds (``time.perf_counter``), comparable
  *within* a run only; ``run`` carries a wall-clock anchor in its
  ``run_start`` event for cross-run alignment;
* ``run`` — process-wide random hex id, shared by every sink in the
  process; ``engine`` — the owning engine's id (or ``"-"`` for
  process-scope events).

Sinks follow the registry's off-switch: when obs is disabled
(``REPRO_OBS=off``), :meth:`EventLog.emit` is a no-op and the file is
never created, so an "off" run provably emits zero events.  ``flush``
and ``close`` are idempotent; emits after ``close`` are dropped.

The default on-disk location comes from ``REPRO_OBS_EVENTS``; with the
env unset an :class:`EventLog` is in-memory only (records still
accumulate for ``Engine.snapshot()`` and tests).  Counterpart of
``repro/obs/events.py``, copied: same envelope, schema version and
environment variable.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Dict, List, Optional

from .registry import obs_enabled

__all__ = ["SCHEMA_VERSION", "ENV_EVENTS", "EventLog", "run_id",
           "default_events_path", "validate_line"]

SCHEMA_VERSION = 1
ENV_EVENTS = "REPRO_OBS_EVENTS"

_RUN_ID = uuid.uuid4().hex[:8]

# Envelope keys every record must carry, in emit order.
_ENVELOPE = ("schema", "seq", "ts", "run", "engine", "kind")


def run_id() -> str:
    """Process-wide run id (stable for the life of the process)."""
    return _RUN_ID


def default_events_path() -> Optional[str]:
    """JSONL sink path from ``REPRO_OBS_EVENTS`` (None = in-memory)."""
    p = os.environ.get(ENV_EVENTS, "").strip()
    return p or None


class EventLog:
    """Append-only event sink: in-memory record list + optional JSONL
    file (opened lazily on the first enabled emit)."""

    def __init__(self, path: Optional[str] = None, engine: str = "-"):
        self.path = path
        self.engine = engine
        self._lock = threading.Lock()
        self._records: List[Dict] = []
        self._fh = None
        self._seq = 0
        self._closed = False

    def emit(self, kind: str, **fields) -> Optional[Dict]:
        """Record one event; returns the record, or None when dropped
        (obs disabled or sink closed)."""
        if self._closed or not obs_enabled():
            return None
        with self._lock:
            if self._closed:                    # re-check under lock
                return None
            rec = {"schema": SCHEMA_VERSION, "seq": self._seq,
                   "ts": round(time.perf_counter(), 6), "run": _RUN_ID,
                   "engine": self.engine, "kind": str(kind)}
            for k, v in fields.items():
                if k not in rec:
                    rec[k] = v
            self._seq += 1
            self._records.append(rec)
            if self.path is not None:
                if self._fh is None:
                    self._fh = open(self.path, "a", encoding="utf-8")
                self._fh.write(json.dumps(rec) + "\n")
            return rec

    def records(self, kind: Optional[str] = None) -> List[Dict]:
        with self._lock:
            recs = list(self._records)
        if kind is not None:
            recs = [r for r in recs if r["kind"] == kind]
        return recs

    @property
    def closed(self) -> bool:
        return self._closed

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.flush()

    def close(self) -> None:
        """Flush and close the file sink; idempotent, emits after this
        are dropped.  In-memory records stay readable."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._fh is not None and not self._fh.closed:
                self._fh.flush()
                self._fh.close()


def validate_line(line: str) -> List[str]:
    """Findings (empty = ok) for one JSONL event line."""
    try:
        rec = json.loads(line)
    except ValueError as e:
        return [f"not valid JSON: {e}"]
    if not isinstance(rec, dict):
        return ["record is not a JSON object"]
    findings = [f"missing envelope key {k!r}" for k in _ENVELOPE
                if k not in rec]
    if rec.get("schema") not in (None, SCHEMA_VERSION):
        findings.append(f"unknown schema version {rec['schema']!r} "
                        f"(expected {SCHEMA_VERSION})")
    if "seq" in rec and not isinstance(rec["seq"], int):
        findings.append("seq is not an integer")
    if "kind" in rec and not isinstance(rec["kind"], str):
        findings.append("kind is not a string")
    return findings
