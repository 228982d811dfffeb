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

Built inside ``sharding.use_mesh`` (every rank of the mesh builds the
same Trainer), it trains on the training mesh (``train/train_step.py``):
each rank initializes the one-device values and keeps its shards, reads
the rows of its batch coordinate (``data.pipeline.mesh_rows`` over
``sharding.batch_axes``), restores onto its shards, checkpoints in the
reference's whole-leaf format (``Checkpointer.save(shardings=)``), feeds
every rank's step time to a watchdog with one host per rank (one
all-gather of the times a step) and plans a restart for the mesh's
ranks.  Rank 0 logs.
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
from repro_torch.parallel import sharding
from repro_torch.runtime import Watchdog, WatchdogConfig, plan_restart
from repro_torch.train.train_step import (TrainStepConfig, init_train_state,
                                          make_train_step, state_shardings)

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
        self.log = log_fn
        self.device = resolve_device(device)
        self.step_fn = make_train_step(cfg, layout, tcfg)
        ctx = sharding.active()
        self.mesh = None if ctx is None else ctx.mesh
        self.shardings = None
        if self.mesh is not None:
            # one "host" per rank of the mesh; data by batch coordinate
            host_id = int(list(self.mesh.devices.reshape(-1)).index(self.mesh.rank))
            num_hosts = self.mesh.size
            self.shardings = state_shardings(cfg, layout, tcfg, ctx)
            self.batch_coord = sharding.mesh_coord(self.mesh, sharding.batch_axes(ctx))
        else:
            self.batch_coord = (host_id, num_hosts)
        self.host_id, self.num_hosts = host_id, num_hosts
        self.ckpt = (Checkpointer(CheckpointConfig(tr.checkpoint_dir),
                                  host_id=host_id, num_hosts=num_hosts)
                     if tr.checkpoint_dir else None)
        self.watchdog = Watchdog(tr.watchdog, num_hosts)

    # ----------------------------------------------------------- state

    def restore_or_init(self):
        """-> (train_state, DataState)."""
        gen = torch.Generator(device=self.device).manual_seed(self.tr.seed)
        state = init_train_state(gen, self.cfg, self.layout, self.tcfg,
                                 device=self.device, shardings=self.shardings)
        data_state = DataState(step=0, seed=self.tr.seed)
        if self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                state, extra = self.ckpt.restore(latest, state, shardings=self.shardings)
                data_state = DataState(**extra.get(
                    "data_state", {"step": latest, "seed": self.tr.seed}))
                if self.host_id == 0:
                    self.log(f"[trainer] restored step {latest}")
        return state, data_state

    def _save(self, step: int, state, data_state) -> None:
        self.ckpt.save(step, state, extra={"data_state": dataclasses.asdict(data_state)},
                       shardings=self.shardings)

    def _heartbeat(self, dt: float) -> None:
        """Every rank's step time into the watchdog (on a mesh, gathered
        from all ranks: each rank's watchdog hears every rank)."""
        if self.mesh is None:
            self.watchdog.heartbeat(self.host_id, dt)
            return
        for h, t in enumerate(self.mesh.gather_values(dt)):
            self.watchdog.heartbeat(h, t)

    # ------------------------------------------------------------ loop

    def run(self, state=None, data_state: Optional[DataState] = None
            ) -> TrainResult:
        if state is None:
            state, data_state = self.restore_or_init()
        coord, shards = self.batch_coord
        pipeline = make_pipeline(self.source, data_state, host_id=coord, num_hosts=shards,
                                 microbatch=self.tcfg.microbatch if self.mesh else 1)
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
            self._heartbeat(dt)

            if step % self.tr.log_every == 0 and self.host_id == 0:
                self.log(f"[trainer] step {step:5d} loss {loss:.4f} "
                         f"lr {float(metrics['lr']):.2e} "
                         f"gnorm {float(metrics['grad_norm']):.2f} "
                         f"({dt*1e3:.0f} ms)")

            report = self.watchdog.check()
            if not report.healthy:
                if self.host_id == 0:
                    self.log(f"[trainer] watchdog: dead={report.dead} "
                             f"stragglers={report.stragglers} -> elastic restart")
                if self.ckpt is not None:
                    self._save(step + 1, state, data_state)
                    self.ckpt.wait()
                alive = max(self.num_hosts - len(report.dead) - len(report.stragglers), 1)
                if self.mesh is None:       # this process's cards
                    alive = alive * _chips(self.device) // max(self.num_hosts, 1)
                return TrainResult(step + 1, losses, restart_plan=plan_restart(alive))

            if (self.ckpt is not None and (step + 1) % self.tr.checkpoint_every == 0):
                self._save(step + 1, state, data_state)

        if self.ckpt is not None:
            self._save(self.tr.steps, state, data_state)
            self.ckpt.wait()
        return TrainResult(self.tr.steps, losses)
