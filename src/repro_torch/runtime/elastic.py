"""Elastic restart planning: re-size the mesh after node loss.

Counterpart of ``repro/runtime/elastic.py`` (pure Python).  The serving
engine's ``rebuild_after_loss`` re-plans its mesh of ranks with it; the
Trainer hands it the chips of this process, and steps 4-5 below wait for
the training mesh, a later slice of the port.

Given the surviving chip count, pick the largest (pods, data, model)
mesh the job can run — model-parallel width is pinned (changing TP
re-shards every weight matrix *layout*, which restore handles, but the
per-layer divisibility story is tuned for tp=16), the data axis shrinks
to the largest divisor that the surviving chips support, and whole pods
drop out of the "pod" axis first (a pod that lost a host is drained —
ICI collectives cannot route around a hole, DCI can).

The restart sequence Trainer follows:

    1. watchdog reports dead/straggler hosts;
    2. checkpointer.wait(); last committed step S is the restore point;
    3. plan = plan_restart(total_chips_alive, ...);
    4. new mesh = make_production_mesh-like mesh from plan;
    5. params/opt restored with shardings built on the new mesh
       (checkpoint/checkpointer.py does the re-shard on device_put);
    6. data pipeline resumes from DataState(S, seed) — bit-exact batches
       re-dealt over the new host set (data/pipeline.py).

Global batch is preserved (more grad accumulation per shard on fewer
chips), so the optimizer trajectory is unchanged across the restart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ElasticPlan", "plan_restart"]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    pods: int
    data: int
    model: int
    microbatch_scale: int   # grad-accum multiplier to keep global batch

    @property
    def chips(self) -> int:
        return self.pods * self.data * self.model

    def mesh_shape(self, multi_pod: bool) -> Tuple[int, ...]:
        return (self.pods, self.data, self.model) if multi_pod \
            else (self.data, self.model)


def plan_restart(chips_alive: int, *, chips_per_pod: int = 256,
                 model: int = 16, old_data: int = 16,
                 old_pods: int = 2) -> Optional[ElasticPlan]:
    """Largest runnable mesh after losing chips; None if < one TP group."""
    if chips_alive < model:
        return None
    # Drain incomplete pods: ICI collectives need a full (data, model) grid.
    pods = min(old_pods, chips_alive // chips_per_pod)
    if pods >= 1:
        data = chips_per_pod // model
    else:
        # Sub-pod survival: shrink the data axis to what's left.
        pods = 1
        data = max(d for d in range(1, old_data + 1)
                   if d * model <= chips_alive and old_data % d == 0)
    old_shards = old_pods * old_data
    new_shards = pods * data
    scale = max(1, -(-old_shards // new_shards))
    return ElasticPlan(pods=pods, data=data, model=model,
                       microbatch_scale=scale)
