"""Batched serving with continuous batching + low-bit packed weights.

    PYTHONPATH=src python -m repro_torch.examples.serve_batch --quant tbn [--device cpu]

Twin of ``examples/serve_batch.py``: requests of different lengths
stream through the slot scheduler; slots free and refill without draining
the batch (watch the "live slots" trace).  With ``--quant tnn/tbn/bnn``
the projection weights run through the paper's low-bit matmul path, and
``--packed`` packs them offline at engine build (Algorithm 2).
``--device`` defaults to ``cuda``; ``main`` returns the engine's results
by uid.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_smoke
from repro_torch.kernels.modes import resolve_device
from repro_torch.models import model as model_mod
from repro_torch.models.common import ShardLayout
from repro_torch.serving import Engine, Request, Result, SamplerConfig, ServeConfig


def main(argv: Optional[List[str]] = None) -> Dict[int, Result]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_batch")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--quant", default="bf16")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--packed", action="store_true",
                    help="pack low-bit projection weights offline at engine build "
                         "(Algorithm 2); decode then runs the fused quantize / popcount / "
                         "scale pipeline per projection")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default cuda; cpu for the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke(args.arch, quant_policy=args.quant)
    layout = ShardLayout(tp=1)
    scfg = ServeConfig(num_slots=args.slots, max_len=128, prefill_bucket=16,
                       sampler=SamplerConfig(temperature=0.7), pack_params=args.packed)
    params = model_mod.init_lm(torch.Generator(device=dev).manual_seed(0), cfg, layout,
                               device=dev)
    engine = Engine(params, cfg, layout, scfg, seed=0)
    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        plen = int(rng.integers(3, 14))
        engine.submit(Request(uid=uid,
                              prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int64),
                              max_new_tokens=int(rng.integers(4, args.new_tokens))))
    t0 = time.time()
    steps = 0
    while engine.step():
        steps += 1
        if steps % 8 == 0:
            live = sum(u != -1 for u in engine.slot_uid)
            print(f"  step {steps:3d}: {live}/{args.slots} slots live, "
                  f"{len(engine.results)} done, {len(engine.queue)} queued")
    dt = time.time() - t0
    results = dict(engine.results)

    tokens = sum(len(r.tokens) for r in results.values())
    packed = " packed" if args.packed else ""
    print(f"\n[serve_batch] quant={args.quant}{packed}: {len(results)} requests, "
          f"{tokens} tokens, {dt:.1f}s ({tokens / max(dt, 1e-9):.1f} tok/s) on {dev}")
    if obs.obs_enabled():
        snap = engine.metrics()["metrics"]
        ttft = snap["repro_engine_ttft_seconds"]["series"]
        n = ttft[0]["value"]["count"] if ttft else 0
        s = ttft[0]["value"]["sum"] if ttft else 0.0
        print(f"[serve_batch] obs: {engine.obs.admissions.total():.0f} admissions, "
              f"{engine.obs.decode_tokens.total():.0f} decode tokens, "
              f"mean TTFT {s / max(n, 1):.3f}s over {n} streams")
        obs.write_snapshot_if_configured(engine.obs.registry)
    engine.close()
    return results


if __name__ == "__main__":
    main()
