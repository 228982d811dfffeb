"""Training launcher, on one device or on a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --smoke --steps 50 --batch 8 --seq 128
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --smoke --quant tnn

Counterpart of ``python -m repro.launch.train``, with its flags.
``--device`` defaults to ``cuda`` and raises without a card (``--device
cpu`` runs the plain versions on the CPU).

Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) every rank joins the
world (``launch.mesh.init_rank``: NCCL when each rank has a card of its
own, gloo otherwise), builds the (1, world) host mesh or, with
``--production``, the reference's 16 x 16 mesh (which raises its
``RuntimeError`` below 256 ranks), takes the layout of its
tensor-parallel axis (``models.common.train_layout``: ``tp`` the "model"
axis' size) and trains under ``TRAIN_RULES`` (``train/trainer.py``): the
heads, FFN and vocab split over "model" and the residual stream holds
sequence shards (with ``--seq`` a multiple of the axis' size; else the
step all-reduces in their place), the batch over "data".  Rank 0 prints
the summary.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from repro_torch.configs import get_config, get_smoke
from repro_torch.data import SyntheticLM
from repro_torch.kernels.modes import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.common import train_layout
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import sharding
from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig
from repro_torch.train.trainer import TrainResult


def main(argv: Optional[List[str]] = None) -> TrainResult:
    """Parse ``argv``, train, print the ``[launch.train]`` summary line;
    returns the run's TrainResult."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--production", action="store_true",
                    help="production 16x16 mesh (needs 256 ranks)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--quant", default=None,
                    help="quant policy: bf16|int8|int4|tnn|tbn|bnn")
    ap.add_argument("--int8-moments", action="store_true")
    ap.add_argument("--ef-compression", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default cuda; cpu for the plain versions)")
    args = ap.parse_args(argv)
    ranked = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if not (ranked or args.production):
        return _train(args, args.device, None)
    dev = mesh_mod.init_rank(args.device) if ranked else resolve_device(args.device)
    try:
        mesh = (mesh_mod.make_production_mesh(device=dev) if args.production
                else mesh_mod.make_host_mesh(dev))
        with sharding.use_mesh(mesh, sharding.TRAIN_RULES):
            return _train(args, dev, mesh)
    finally:
        mesh_mod.shutdown()


def _train(args, device, mesh) -> TrainResult:
    over = {"quant_policy": args.quant} if args.quant else {}
    cfg = (get_smoke(args.arch, **over) if args.smoke
           else get_config(args.arch, **over))
    tcfg = TrainStepConfig(
        optimizer=AdamWConfig(
            lr=args.lr, total_steps=args.steps,
            warmup_steps=max(1, args.steps // 10),
            moments_dtype="int8" if args.int8_moments else "f32"),
        microbatch=args.microbatch,
        ef_compression=args.ef_compression,
    )
    source = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)
    tr = TrainerConfig(steps=args.steps, seed=args.seed,
                       checkpoint_dir=args.checkpoint_dir,
                       checkpoint_every=max(10, args.steps // 4))
    trainer = Trainer(cfg, train_layout(), tcfg, tr, source, device=device)
    result = trainer.run()
    if mesh is not None and trainer.host_id != 0:
        return result
    where = (trainer.device if mesh is None
             else f"{mesh.size} ranks, mesh {mesh.shape} ({mesh.backend})")
    print(f"[launch.train] done at step {result.final_step}; "
          f"loss {result.losses[0]:.3f} -> {result.losses[-1]:.3f} on {where}")
    return result


if __name__ == "__main__":
    main()
