"""CLI for obs artifacts: render snapshots, dump event logs, validate.

Usage::

    python -m repro_torch.obs --snapshot obs_snapshot.json            # Prometheus text
    python -m repro_torch.obs --snapshot obs_snapshot.json --check    # validate, exit 1 on findings
    python -m repro_torch.obs --events obs_events.jsonl               # pretty-print records
    python -m repro_torch.obs --events obs_events.jsonl --check       # validate schema

``--check`` validates snapshot files against the metric catalog
(schema version, no unregistered names, label sets match) and event
logs against the envelope schema; any finding prints to stderr and the
process exits 1.  Counterpart of ``python -m repro.obs``; the two read
each other's artifacts.
"""

import argparse
import json
import sys

from .catalog import check_snapshot
from .events import validate_line
from .registry import to_prometheus


def _check_events(path):
    findings = []
    n = 0
    with open(path, encoding="utf-8") as fh:
        for i, line in enumerate(fh, 1):
            if not line.strip():
                continue
            n += 1
            findings += [f"{path}:{i}: {f}" for f in validate_line(line)]
    return n, findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Render / validate obs snapshots and event logs.")
    ap.add_argument("--snapshot", metavar="PATH",
                    help="registry snapshot JSON to render or check")
    ap.add_argument("--events", metavar="PATH",
                    help="JSONL event log to dump or check")
    ap.add_argument("--check", action="store_true",
                    help="validate instead of render; exit 1 on findings")
    args = ap.parse_args(argv)
    if not args.snapshot and not args.events:
        ap.error("need --snapshot and/or --events")

    findings = []
    if args.snapshot:
        with open(args.snapshot, encoding="utf-8") as fh:
            snap = json.load(fh)
        if args.check:
            findings += [f"{args.snapshot}: {f}" for f in check_snapshot(snap)]
            n = len(snap.get("metrics", {}))
            print(f"{args.snapshot}: {n} metrics, "
                  f"{len(findings)} finding(s)")
        else:
            sys.stdout.write(to_prometheus(snap))
    if args.events:
        n, ev_findings = _check_events(args.events)
        if args.check:
            findings += ev_findings
            print(f"{args.events}: {n} events, "
                  f"{len(ev_findings)} finding(s)")
        else:
            with open(args.events, encoding="utf-8") as fh:
                for line in fh:
                    if line.strip():
                        rec = json.loads(line)
                        print(json.dumps(rec, sort_keys=True))
    for f in findings:
        print(f"FINDING: {f}", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
