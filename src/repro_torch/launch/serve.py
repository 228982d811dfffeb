"""Serving launcher: batched requests through the continuous-batching
engine, on one device or on a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch tinyllama-1.1b --smoke --requests 16 --new-tokens 24
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch tinyllama-1.1b --smoke --quant tnn

Counterpart of ``python -m repro.launch.serve``, with its flags.
``--device`` defaults to ``cuda`` and raises without a card (``--device
cpu`` runs the plain versions on the CPU).  Parameters come from the
port's ``init_lm`` with a generator seeded by ``--seed`` on that device.

Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) every rank joins the
world (``launch.mesh.init_rank``: NCCL when each rank has a card of its
own, gloo otherwise) and serves the same requests on the (1, world) host
mesh with the ``serve_lowbit`` rules: the low-bit projections are packed
and each rank keeps its slice of the planes (``ServeConfig.mesh``).
``--production`` builds the reference's 16 x 16 mesh and raises its
``RuntimeError`` when fewer than 256 ranks exist.  Rank 0 prints the
summary.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels.modes import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model as model_mod
from repro_torch.models.common import ShardLayout
from repro_torch.serving import Engine, Request, Result, SamplerConfig, ServeConfig


def main(argv: Optional[List[str]] = None) -> Dict[int, Result]:
    """Parse ``argv``, serve the requests, print the ``[launch.serve]``
    summary line; returns the results by uid."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--quant", default=None)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default cuda; cpu for the plain versions)")
    args = ap.parse_args(argv)
    ranked = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if not (ranked or args.production):
        return _serve(args, resolve_device(args.device), None)
    dev = mesh_mod.init_rank(args.device) if ranked else resolve_device(args.device)
    try:
        mesh = (mesh_mod.make_production_mesh(device=dev) if args.production
                else mesh_mod.make_host_mesh(dev))
        return _serve(args, dev, mesh)
    finally:
        mesh_mod.shutdown()


def _serve(args, dev: torch.device, mesh) -> Dict[int, Result]:
    over = {"quant_policy": args.quant} if args.quant else {}
    cfg = get_smoke(args.arch, **over) if args.smoke else get_config(args.arch, **over)
    tp = 1 if mesh is None else dict(zip(mesh.axis_names, mesh.shape)).get("model", 1)
    layout = ShardLayout(tp=tp)
    scfg = ServeConfig(num_slots=args.slots, max_len=args.max_len, prefill_bucket=32,
                       sampler=SamplerConfig(temperature=args.temperature),
                       mesh=mesh, mesh_rules="serve_lowbit", pack_params=mesh is not None)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_mod.init_lm(gen, cfg, layout, device=dev)
    engine = Engine(params, cfg, layout, scfg, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for uid in range(args.requests):
        plen = int(rng.integers(4, 24))
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int64)
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=args.new_tokens))
    results = engine.run()
    dt = time.time() - t0
    engine.close()

    total_tokens = sum(len(r.tokens) for r in results.values())
    if mesh is not None and mesh.rank != 0:
        return results
    where = dev if mesh is None else f"{mesh.size} ranks, mesh {mesh.shape} ({mesh.backend})"
    print(f"[launch.serve] {len(results)}/{args.requests} requests, "
          f"{total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens / max(dt, 1e-9):.1f} tok/s) on {where}")
    for uid in sorted(results)[:4]:
        print(f"  req {uid}: {results[uid].tokens[:12]} ...")
    return results


if __name__ == "__main__":
    main()
