"""Run one benchmark cell once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from the start of this process): the kernel
libraries load (the first run in a checkout builds them into
``build/kernels/``), the cell's weights and inputs are made on the card
from ``--seed``, the cell's driver warms up its own shapes.  Then the
closed loop runs for ``--seconds``.  With ``--trace 1`` a short stretch
of the same work runs under ``torch.profiler`` after the window, and the
result holds the cell's per-layer metrics instead of its end-to-end
ones.  Then a driver that checks stage by stage runs units of the
window once more with their stages recorded (``record``), the program's
state is freed, and the plain reference checks what the timed path
produced; the numbers compared and their limits are the last lines on
standard error and the last key of the result.

A cell that asks for more than one chip runs on as many cards: this
process is rank 0 and starts the others (``gpubench/ranks.py``).

The last line on standard output is the result (JSON).  Without a CUDA
device (or with fewer than the cell asks for), without the program's
package, with JAX or the JAX package loaded by the end, or where another
rank fails, the run exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from gpubench import calibrate, harness, ranks  # noqa: E402


def _per_layer(cell, trace) -> dict:
    out = {}
    for m in cell.per_layer:
        value = harness.metric_reader(m["name"]).read(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
             t0: float = None, fault: str = None) -> dict:
    """Set up, measure and check ``cell`` on ``device`` (rank 0's, where
    the cell has more ranks: ``gpubench/ranks.py``); the result line's
    object (the numbers compared under its last key, "checks").
    ``fault`` plants one of ``calibrate``'s faults on every rank."""
    import torch

    t0 = T0 if t0 is None else t0
    cuda = device.type == "cuda"
    drv = harness.load_module("drivers", cell.traffic["driver"])
    with ranks.lead(cell, seed, device, fault) as lead, calibrate.plant(cell, fault):
        run = drv.Run(cell, seed, device)
        lead.built()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t0
        first = getattr(run, "first_window_unit", lambda: 0)()
        window = harness.closed_loop(lead.unit(run), seconds, first)
        dev = harness.device_info(torch, device, cell.chips,
                                  [r["peak"] for r in lead.settle("report")])
        result = {"correct": False, "attempted": window.done, "failed": 0}
        if trace:
            units = run.units_for_trace()
            begin = [first + window.done]

            def stretch():
                lead.announce("stretch", begin[0], units)
                for i in range(begin[0], begin[0] + units):
                    run.step(i)
                begin[0] += units
            tr = harness.Trace(units, window.per_unit_s, [], [], 0.0, run.work(),
                               dev["memory_peak_bytes"])
            # a profiler session now and then records no device operation
            for _ in range(3 if cuda else 0):
                lead.settle("profile")
                tr = harness.profile(stretch, units, window.per_unit_s, run.work(),
                                     dev["memory_peak_bytes"])
                if tr.kernels:
                    break
            metrics = _per_layer(cell, tr)
            busy = [tr.busy_s] + [r["busy_s"] for r in lead.settle("report")
                                  if r["busy_s"] is not None]
            dev.update(busy_s=sum(busy) / len(busy), window_s=tr.window_s)
            result["breakdown"] = harness.breakdown(tr)
        else:
            values = run.end_to_end(window)
            values["setup_s"] = (setup_s, "s")
            metrics = {}
            for m in cell.end_to_end:
                value, unit = values[m["name"]]
                metrics[m["name"]] = {"value": value, "unit": unit}
        if hasattr(run, "record"):
            lead.call(run, "record")
        lead.call(run, "release")
        checks = lead.call(run, "check")
        lead.end()
    limits = {name: cell.limits[name]["limit"] for name in checks}
    bad = [name for name, v in checks.items() if not v <= limits[name]]
    result.update(correct=not bad, failed=len(bad), metrics=metrics, device=dev)
    result["checks"] = {name: {"value": v, "limit": limits[name]} for name, v in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    harness.set_cache_dirs()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0))
    except ranks.RankFailed as e:
        # a rank that failed can leave this process's collectives waiting
        # on the device, and the interpreter's teardown with them
        print(f"gpubench: {e}", file=sys.stderr, flush=True)
        os._exit(4)
    found = harness.forbidden_modules()
    if found:
        print(f"gpubench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
