"""Training launcher, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --smoke --steps 50 --batch 8 --seq 128

Counterpart of ``python -m repro.launch.train``, with its flags.
``--device`` defaults to ``cuda`` and raises without a card (``--device
cpu`` runs the plain versions on the CPU).  ``--production`` (the
reference's multi-host 16 x 16 mesh) belongs to the training-mesh slice
(ROADMAP.md, queue 1) and raises.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.configs import get_config, get_smoke
from repro_torch.data import SyntheticLM
from repro_torch.models.common import ShardLayout
from repro_torch.optim.adamw import AdamWConfig
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
                    help="production 16x16 mesh (not ported yet)")
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
    if args.production:
        raise NotImplementedError(
            "--production (the multi-host training mesh) is not ported yet: it belongs "
            "to the training-mesh slice (ROADMAP.md, queue 1)")

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
    trainer = Trainer(cfg, ShardLayout(tp=1), tcfg, tr, source, device=args.device)
    result = trainer.run()
    print(f"[launch.train] done at step {result.final_step}; "
          f"loss {result.losses[0]:.3f} -> {result.losses[-1]:.3f} on {trainer.device}")
    return result


if __name__ == "__main__":
    main()
