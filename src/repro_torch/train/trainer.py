"""The training loop: data -> step -> metrics/checkpoint/watchdog.

Counterpart of ``repro/train/trainer.py``.  The loop is deliberately
boring — the cleverness lives in the step and the subsystems it
composes:

* resumable: ``Trainer.restore_or_init()`` restores the newest committed
  checkpoint (params, optimizer, data state) if one exists;
* fault-tolerant: heartbeats feed the Watchdog; an unhealthy report
  triggers a save, ``wait()`` and elastic restart planning (surfaced to
  the launcher via TrainResult.restart_plan — re-exec is the launcher's
  job), planned for the cards of this process;
* async checkpointing every ``checkpoint_every`` steps.

Everything lives on ``device`` (default ``"cuda"``, which raises without
a card); the parameters are drawn from a generator seeded with
``TrainerConfig.seed`` there, the batches are the numpy pipeline's,
moved to the device each step.  The loss is read on the host once per
step (``float``), which also waits for the step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import torch

from repro_torch.checkpoint import CheckpointConfig, Checkpointer
from repro_torch.data import DataState, SyntheticLM, make_pipeline
from repro_torch.kernels.modes import DEFAULT_DEVICE, resolve_device
from repro_torch.models.common import ModelConfig, ShardLayout
from repro_torch.runtime import Watchdog, WatchdogConfig, plan_restart
from repro_torch.train.train_step import (TrainStepConfig, init_train_state,
                                          make_train_step)

__all__ = ["TrainerConfig", "TrainResult", "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    steps: int = 100
    seed: int = 0
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    watchdog: WatchdogConfig = dataclasses.field(default_factory=WatchdogConfig)


@dataclasses.dataclass
class TrainResult:
    final_step: int
    losses: List[float]
    restart_plan: Optional[Any] = None   # ElasticPlan if the watchdog fired


def _chips(dev: torch.device) -> int:
    """Cards this process drives: every visible one on CUDA, 1 on the CPU."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


class Trainer:
    def __init__(self, cfg: ModelConfig, layout: ShardLayout,
                 tcfg: TrainStepConfig, tr: TrainerConfig,
                 source: SyntheticLM, *,
                 host_id: int = 0, num_hosts: int = 1,
                 log_fn: Callable[[str], None] = print,
                 device=DEFAULT_DEVICE):
        self.cfg, self.layout, self.tcfg, self.tr = cfg, layout, tcfg, tr
        self.source = source
        self.host_id, self.num_hosts = host_id, num_hosts
        self.log = log_fn
        self.device = resolve_device(device)
        self.step_fn = make_train_step(cfg, layout, tcfg)
        self.ckpt = (Checkpointer(CheckpointConfig(tr.checkpoint_dir),
                                  host_id=host_id, num_hosts=num_hosts)
                     if tr.checkpoint_dir else None)
        self.watchdog = Watchdog(tr.watchdog, num_hosts)

    # ----------------------------------------------------------- state

    def restore_or_init(self):
        """-> (train_state, DataState)."""
        gen = torch.Generator(device=self.device).manual_seed(self.tr.seed)
        state = init_train_state(gen, self.cfg, self.layout, self.tcfg,
                                 device=self.device)
        data_state = DataState(step=0, seed=self.tr.seed)
        if self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                state, extra = self.ckpt.restore(latest, state)
                data_state = DataState(**extra.get(
                    "data_state", {"step": latest, "seed": self.tr.seed}))
                self.log(f"[trainer] restored step {latest}")
        return state, data_state

    # ------------------------------------------------------------ loop

    def run(self, state=None, data_state: Optional[DataState] = None
            ) -> TrainResult:
        if state is None:
            state, data_state = self.restore_or_init()
        pipeline = make_pipeline(self.source, data_state,
                                 host_id=self.host_id,
                                 num_hosts=self.num_hosts)
        losses: List[float] = []
        start_step = data_state.step
        for step in range(start_step, self.tr.steps):
            data_state, batch = next(pipeline)
            t0 = time.monotonic()
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            losses.append(loss)
            self.watchdog.heartbeat(self.host_id, dt)

            if step % self.tr.log_every == 0 and self.host_id == 0:
                self.log(f"[trainer] step {step:5d} loss {loss:.4f} "
                         f"lr {float(metrics['lr']):.2e} "
                         f"gnorm {float(metrics['grad_norm']):.2f} "
                         f"({dt*1e3:.0f} ms)")

            report = self.watchdog.check()
            if not report.healthy:
                self.log(f"[trainer] watchdog: dead={report.dead} "
                         f"stragglers={report.stragglers} -> elastic restart")
                if self.ckpt is not None:
                    self.ckpt.save(step + 1, state,
                                   extra={"data_state": dataclasses.asdict(
                                       data_state)})
                    self.ckpt.wait()
                alive = (self.num_hosts - len(report.dead)
                         - len(report.stragglers))
                plan = plan_restart(max(alive, 1) * _chips(self.device)
                                    // max(self.num_hosts, 1))
                return TrainResult(step + 1, losses, restart_plan=plan)

            if (self.ckpt is not None and (step + 1) % self.tr.checkpoint_every == 0):
                self.ckpt.save(step + 1, state,
                               extra={"data_state": dataclasses.asdict(data_state)})

        if self.ckpt is not None:
            self.ckpt.save(self.tr.steps, state,
                           extra={"data_state": dataclasses.asdict(data_state)})
            self.ckpt.wait()
        return TrainResult(self.tr.steps, losses)
