"""End-to-end example: train a small LM on synthetic (but learnable) data,
with low-bit QAT on the projections.

    PYTHONPATH=src python -m repro_torch.examples.train_tinylm \
        --steps 300 --quant tnn --d-model 256 [--device cpu]

Twin of ``examples/train_tinylm.py``: a cut of TinyLlama
(``TRAIN_100M`` shrunk by ``--d-model`` / ``--layers``), AdamW with a
cosine schedule and clipping, async checkpoints.  The loss must fall
well below the uniform baseline ln(V): the synthetic stream is an
order-1 Markov chain, so there is real signal to learn.  ``--device``
defaults to ``cuda``; ``main`` returns the run's ``TrainResult``.
"""

from __future__ import annotations

import argparse
import math
import tempfile
from typing import List, Optional

from repro_torch.configs.tinyllama_1_1b import TRAIN_100M
from repro_torch.data import SyntheticLM
from repro_torch.models.common import ShardLayout
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig
from repro_torch.train.trainer import TrainResult


def main(argv: Optional[List[str]] = None) -> TrainResult:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_tinylm")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--quant", default="bf16", help="bf16 | int8 | int4 | tnn | tbn | bnn")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default cuda; cpu for the plain versions)")
    args = ap.parse_args(argv)

    cfg = TRAIN_100M.with_(
        name="tinylm-example", num_layers=args.layers, d_model=args.d_model,
        num_heads=max(4, args.d_model // 64), num_kv_heads=2,
        d_ff=int(args.d_model * 8 / 3) // 64 * 64, vocab_size=args.vocab,
        quant_policy=args.quant, remat=False)
    ckpt_dir = args.checkpoint_dir or tempfile.mkdtemp(prefix="tinylm_ckpt_")
    tcfg = TrainStepConfig(optimizer=AdamWConfig(
        lr=args.lr, total_steps=args.steps, warmup_steps=args.steps // 10, weight_decay=0.01))
    source = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, noise=0.05, order=1)
    tr = TrainerConfig(steps=args.steps, checkpoint_dir=ckpt_dir,
                       checkpoint_every=max(50, args.steps // 4), log_every=20)
    trainer = Trainer(cfg, ShardLayout(tp=1), tcfg, tr, source, device=args.device)
    result = trainer.run()

    uniform = math.log(cfg.vocab_size)
    first = sum(result.losses[:10]) / min(10, len(result.losses))
    last = sum(result.losses[-10:]) / min(10, len(result.losses))
    print(f"\n[train_tinylm] quant={args.quant}  loss {first:.3f} -> {last:.3f}  "
          f"(uniform {uniform:.3f}) on {trainer.device}")
    print(f"[train_tinylm] checkpoints in {ckpt_dir}")
    if not last < uniform - 0.5:
        raise AssertionError("no learning happened!")
    return result


if __name__ == "__main__":
    main()
