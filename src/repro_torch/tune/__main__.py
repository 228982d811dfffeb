"""Offline autotuning sweeps: ``python -m repro_torch.tune``.

    PYTHONPATH=src python -m repro_torch.tune \\
        --shapes 16x256x512 128x256x512 --modes tnn bnn --backends cuda \\
        --cache plans.json --report tune_report.json

Measures every (shape x mode x backend) with a tunable registered
kernel on ``--device`` (default ``cuda``: the card, and an error without
one; ``--device cpu`` times the plain versions), persists the winning
plans to the cache file (atomic write) and prints one line per plan.  A
second identical run is a pure cache hit: it measures nothing
(``measured=0`` in the summary line) and re-saves a byte-identical
file.  ``--report`` writes the per-candidate timings to a separate JSON;
timings never enter the plan cache.  Counterpart of ``python -m
repro.tune``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Tuple


def _parse_shape(s: str) -> Tuple[int, int, int]:
    try:
        m, n, k = (int(v) for v in s.lower().split("x"))
        if min(m, n, k) < 1:
            raise ValueError
        return m, n, k
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"shape must be MxNxK positive ints, got {s!r}") from None


def _parse_conv_shape(s: str) -> Tuple[int, ...]:
    """BxHxWxCINxCOUTxKH[xKW] — one implicit-im2col conv geometry."""
    try:
        parts = [int(v) for v in s.lower().split("x")]
        if len(parts) == 6:
            parts.append(parts[5])          # square kernel shorthand
        if len(parts) != 7 or min(parts) < 1:
            raise ValueError
        return tuple(parts)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"conv shape must be BxHxWxCINxCOUTxKH[xKW] positive ints, "
            f"got {s!r}") from None


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="offline per-shape tile search for the low-bit GeMM kernels")
    ap.add_argument("--shapes", type=_parse_shape, nargs="+",
                    default=[(16, 256, 512), (128, 256, 512)], metavar="MxNxK",
                    help="problem shapes (activation m x out n x depth k)")
    ap.add_argument("--conv-shapes", type=_parse_conv_shape, nargs="+", default=[],
                    metavar="BxHxWxCINxCOUTxKH[xKW]",
                    help="implicit-im2col conv geometries (their tiles are compiled "
                         "in: they keep the default plan)")
    ap.add_argument("--conv-stride", type=int, default=1)
    ap.add_argument("--conv-padding", type=str, default="SAME", choices=["SAME", "VALID"])
    ap.add_argument("--modes", nargs="+", default=["bnn", "tnn", "tbn"],
                    help="quantization modes to tune")
    ap.add_argument("--backends", nargs="+", default=["cuda", "torch"],
                    help="kernel backends to tune (cuda, torch, dense, indexed)")
    ap.add_argument("--unfused", action="store_true",
                    help="tune the int32-core kernels instead of the fused ones")
    ap.add_argument("--cache", type=str, default=None,
                    help="plan cache path (default: $REPRO_TUNE_CACHE or "
                         "~/.cache/repro_torch/tune_plans.json)")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed repetitions per candidate (median kept)")
    ap.add_argument("--warmup", type=int, default=2,
                    help="untimed warm-up calls per candidate")
    ap.add_argument("--seed", type=int, default=0, help="seed of the operands")
    ap.add_argument("--device", default="cuda",
                    help="device to measure on (default cuda; cpu for the plain versions)")
    ap.add_argument("--report", type=str, default=None,
                    help="also write the per-candidate timing table here")
    args = ap.parse_args(argv)

    from repro_torch.kernels.modes import QuantMode, resolve_device
    from repro_torch.tune import cache as plan_cache
    from repro_torch.tune import tuner

    device = resolve_device(args.device)
    modes = [QuantMode(m) for m in args.modes]
    if args.cache:
        plan_cache.set_cache_path(args.cache)
    cache = plan_cache.get_cache()
    conv_problems = [
        tuner.ConvProblem(batch=b, height=h, width=w, cin=ci, cout=co, kernel_h=kh,
                          kernel_w=kw, stride=args.conv_stride, padding=args.conv_padding)
        for (b, h, w, ci, co, kh, kw) in args.conv_shapes]

    print(f"tuning {len(args.shapes)} shapes + {len(conv_problems)} conv geometries x "
          f"{args.modes} x {args.backends} ({'unfused' if args.unfused else 'fused'}) "
          f"on device '{plan_cache.device_kind(device)}'")
    _, stats, reports = tuner.tune_shapes(
        args.shapes, modes, args.backends, fused=not args.unfused, reps=args.reps,
        warmup=args.warmup, seed=args.seed, verbose=True, conv_problems=conv_problems,
        device=device)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(reports, f, indent=2, sort_keys=True)
        print(f"wrote timing report ({len(reports)} measured entries) to {args.report}")
    print(f"tune summary: measured={stats['measured']} cached={stats['cached']} "
          f"skipped={stats['skipped']} plans={len(cache)} cache={cache.path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
