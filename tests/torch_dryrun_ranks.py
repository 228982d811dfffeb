"""One rank of the port's dry-run mesh check (``tests/test_torch_dryrun.py``).

The test starts this script as 4 ranks of a gloo world on the CPU
(``launch.mesh.run_ranks``) and holds what each rank writes to
``rank<r>.json`` against the same runs on a ``PlaceholderMesh`` on
``meta``.  The script imports neither JAX nor the JAX package:

    python tests/torch_dryrun_ranks.py <dir>        (RANK, WORLD_SIZE, ... set)

Every rank:

* one train step of :func:`train_case` on the (2, 2) ("data", "model")
  mesh under ``TRAIN_RULES``: the bytes of its train state and the
  training mesh's collectives of the step (``launch.mesh.collectives``,
  counts and bytes per kind and dtype);
* one prefill of :func:`serve_case` on the (1, 4) mesh under the
  ``serve_lowbit`` rules, the weights packed under it: the serving mesh's
  collectives (``parallel.qmm_mesh.collectives``) and its ``qmm`` requests.
"""

import json
import os
import sys

import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke
from repro_torch.data import DataState, SyntheticLM, make_pipeline
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model
from repro_torch.models.common import ShardLayout
from repro_torch.models.kvcache import init_caches
from repro_torch.models.packing import pack_lm_params
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import qmm_mesh, sharding
from repro_torch.roofline.op_stats import tree_bytes
from repro_torch.train import TrainStepConfig, make_train_step
from repro_torch.train.train_step import init_train_state, state_shardings

TRAIN_MESH, SERVE_MESH = (2, 2), (1, 4)
BATCH, SEQ, PROMPT = 8, 16, 12


def train_case():
    """12a's configuration at smoke size (widths every mesh axis divides):
    -> (cfg, tcfg, layout, source)."""
    cfg = get_smoke("tinyllama-1.1b", quant_policy="tnn").with_(d_model=128, d_ff=256,
                                                                remat=True)
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=3e-4, warmup_steps=1,
                                                 moments_dtype="int8"), ef_compression=True)
    source = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=0)
    return cfg, tcfg, ShardLayout(tp=TRAIN_MESH[1]), source


def serve_case():
    """11c's configuration at smoke size: -> (cfg, layout)."""
    return get_smoke("tinyllama-1.1b", quant_policy="tnn").with_(d_model=128, d_ff=256), \
        ShardLayout()


def strip(coll):
    """A collective counter without its host seconds."""
    return {k: v for k, v in coll.items() if not k.endswith("_s")}


def main(out_dir: str) -> int:
    dev = mesh_mod.init_rank("cpu", timeout_s=120)
    rank = dist.get_rank()
    train_mesh = mesh_mod.make_mesh(TRAIN_MESH, ("data", "model"), device=dev)
    serve_mesh = mesh_mod.make_mesh(SERVE_MESH, ("data", "model"), device=dev)
    out = {"rank": rank, "coords": train_mesh.coords}
    cfg, tcfg, layout, source = train_case()
    with sharding.use_mesh(train_mesh, sharding.TRAIN_RULES):
        sh = state_shardings(cfg, layout, tcfg)
        state = init_train_state(torch.Generator().manual_seed(0), cfg, layout, tcfg,
                                 device=dev, shardings=sh)
        out["state_bytes"] = tree_bytes(state)
        coord, shards = sharding.mesh_coord(train_mesh, sharding.batch_axes())
        _, batch = next(make_pipeline(source, DataState(0, 0), host_id=coord,
                                      num_hosts=shards))
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        mesh_mod.reset_collectives()
        make_train_step(cfg, layout, tcfg)(state, batch)
        out["train_collectives"] = strip(mesh_mod.collectives())
    cfg, layout = serve_case()
    requests = []
    real_qmm = ops.qmm

    def qmm(x, qt, **kw):
        requests.append([qt.mode.value, int(x.shape[0]), int(qt.out_features), int(x.shape[1])])
        return real_qmm(x, qt, **kw)

    with sharding.use_mesh(serve_mesh, sharding.RULESETS["serve_lowbit"]), torch.no_grad():
        params = model.init_lm(torch.Generator().manual_seed(0), cfg, layout,
                               dtype=torch.bfloat16, device=dev)
        packed = pack_lm_params(params, cfg)
        caches = init_caches(cfg, layout, 2, PROMPT, device=dev)
        qmm_mesh.reset_collectives()
        ops.qmm = qmm
        try:
            model.prefill(packed, {"tokens": torch.zeros((2, PROMPT), dtype=torch.int64)},
                          caches, cfg, layout)
        finally:
            ops.qmm = real_qmm
        out["serve_collectives"] = strip(qmm_mesh.collectives())
        out["serve_requests"] = requests
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    train_mesh.barrier()
    mesh_mod.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
