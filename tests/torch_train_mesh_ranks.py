"""One rank of the port's CPU training-mesh checks
(``tests/test_torch_train_mesh.py``).

``test_torch_train_mesh.py`` writes the inputs (the reference's initial
train states and a batch, as numpy; a checkpoint the reference wrote) into
a directory, starts this script as 4 ranks of a gloo world on the CPU
(``launch.mesh.run_ranks``) and asserts on what the ranks write back:
``rank0.pt`` (whole leaves, gathered) and ``rank<r>.pt`` (each rank's own
readings).  The script imports neither JAX nor the JAX package:

    python tests/torch_train_mesh_ranks.py <dir>             (RANK, WORLD_SIZE, ... set)
    python tests/torch_train_mesh_ranks.py --launch <dir>    (2 ranks: launch.train,
                                                             saving its checkpoint)

On 4 ranks:

* one train step per case of :data:`CASES` (mesh shape, ruleset, policy,
  moments, EF, bf16 wire, microbatches, global batch), from the
  reference's state carried across with ``interop.train_state_from_numpy``
  onto the shards; the updated state gathered whole and the metrics;
* each rank's bytes of masters, moments and EF buffers;
* the first quantized projection of case "A": its weight planes, this
  rank's rows, their activation statistics and the int32 core;
* EF compression and AdamW on shards against the same whole inputs;
* an int8 moment whose shards cut its 256-blocks;
* a checkpoint saved on (2, 2), restored onto (4, 1) and stepped once more,
  beside the same step without the disk; the reference's checkpoint
  restored onto (2, 2);
* the MoE aux loss on a split batch;
* a Trainer whose rank 3 reports slow steps: the watchdog on every rank.
"""

import os
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import interop
from repro_torch.checkpoint import CheckpointConfig, Checkpointer
from repro_torch.configs import get_smoke
from repro_torch.core import quantize
from repro_torch.data.pipeline import mesh_rows
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.common import ShardLayout
from repro_torch.optim import AdamWConfig, adamw, compression
from repro_torch.parallel import sharding
from repro_torch.train import TrainStepConfig, make_train_step
from repro_torch.train.train_step import init_train_state, state_shardings
from repro_torch.tree import flatten_with_paths, map_with_paths

ARCH = "tinyllama-1.1b"
TL = ShardLayout(tp=1)
# name: (mesh shape, rules, policy, moments, ef, bf16 wire, microbatches, batch key)
CASES = {
    "A": ((2, 2), "train", "tnn", "f32", False, False, 1, "batch"),
    "B": ((2, 2), "train", "tnn", "int8", True, True, 1, "batch"),
    "C": ((1, 4), "train", "bnn", "int8", True, True, 2, "batch"),
    "D": ((2, 2), "train_fsdp", "tnn", "f32", True, True, 2, "batch"),
    "E": ((2, 2), "train_fsdp", "tnn", "f32", False, False, 1, "batch6"),
}
LR = 1e-3


def step_config(policy, moments, ef, wire, micro, clip=1.0, arch=ARCH):
    cfg = get_smoke(arch).with_(dtype=torch.float32, quant_policy=policy)
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=LR, warmup_steps=1, moments_dtype=moments,
                                                 clip_norm=clip),
                           seq_chunk=8, z_loss=1e-4, ef_compression=ef,
                           cast_params_bf16=wire, microbatch=micro)
    return cfg, tcfg


def state_key(moments, ef):
    return f"{moments}-{int(ef)}"


def local_rows(mesh, n, micro):
    coord, shards = sharding.mesh_coord(mesh, sharding.batch_axes())
    return mesh_rows(n, coord, shards, micro)


def tensors(batch, rows):
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in batch.items()}


def whole(state, sh):
    """Every leaf gathered whole, as numpy (collective)."""
    return dict(flatten_with_paths(interop.train_state_to_numpy(state, sh)))


def local_bytes(state):
    out = {}
    for path, t in flatten_with_paths(state):
        group = path.split("/")[0] if not path.startswith("opt/") else "opt"
        out[group] = out.get(group, 0) + t.numel() * t.element_size()
    return out


def record_first_qmm(box):
    """Wrap ``ops.qmm`` to keep the first low-bit call's planes, rows and
    statistics (the first forward's first projection)."""
    real = ops.qmm

    def qmm(x, qt, *, backend=None, act_stats=None):
        if not box and qt.mode.is_lowbit:
            x32 = x.detach().to(torch.float32)
            xa = ops.quantize_activations(x32, qt.mode, stats=act_stats)
            stats = act_stats or {"scale": xa["scale"]}
            if act_stats is None and qt.mode.value != "bnn":
                stats["thr"] = quantize.ternary_threshold(x32)
            box.update(x=x.detach().clone(), planes={k: v.clone() for k, v in qt.payload.items()},
                       stats={k: v.clone() for k, v in stats.items()},
                       core=ops.packed_matmul({k: xa[k] for k in xa if k != "scale"}, qt,
                                              backend="torch"))
        return real(x, qt, backend=backend, act_stats=act_stats)
    return real, qmm


def step_cases(inp, out, mesh_of):
    for name, (shape, rules, policy, moments, ef, wire, micro, bkey) in CASES.items():
        mesh = mesh_of(shape)
        cfg, tcfg = step_config(policy, moments, ef, wire, micro)
        with sharding.use_mesh(mesh, sharding.RULESETS[rules]):
            sh = state_shardings(cfg, TL, tcfg)
            state = interop.train_state_from_numpy(inp["states"][state_key(moments, ef)],
                                                   "cpu", shardings=sh)
            out["bytes"][name] = local_bytes(state)
            batch = inp[bkey]
            rows = local_rows(mesh, batch["labels"].shape[0], micro)
            out["rows"][name] = rows.tolist()
            box = {}
            real, hooked = record_first_qmm(box)
            ops.qmm = hooked
            try:
                state, met = make_train_step(cfg, TL, tcfg)(state, tensors(batch, rows))
            finally:
                ops.qmm = real
            out["metrics"][name] = {k: float(v) for k, v in met.items()}
            out["first_qmm"][name] = box
            w = whole(state, sh)
            if mesh.rank == 0:
                out["states"][name] = w


def ef_and_adamw_checks(inp, out, mesh):
    """EF compression and AdamW (clip off) on shards of the same whole
    inputs as one device gets."""
    with sharding.use_mesh(mesh, sharding.TRAIN_RULES):
        for moments in ("f32", "int8"):
            cfg, tcfg = step_config("tnn", moments, True, True, 1, clip=0.0)
            sh = state_shardings(cfg, TL, tcfg)
            state = interop.train_state_from_numpy(inp["states"][state_key(moments, True)],
                                                   "cpu", shardings=sh)
            grads = map_with_paths(lambda p, t: sh_by(sh["params"], p).shard(t, mesh),
                                   to_tensors(inp["grads"]))
            err = map_with_paths(lambda p, t: sh_by(sh["params"], p).shard(t, mesh),
                                 to_tensors(inp["ef_err"]))
            deq, new_err = compression.ef_compress_update(grads, err, mesh=mesh)
            out["ef"][moments] = {"deq": gather_params(deq, sh, mesh),
                                  "err": gather_params(new_err, sh, mesh)}
            new_p, new_o, met = adamw.adamw_update(deq, state["opt"], state["params"],
                                                   tcfg.optimizer, shardings=sh, mesh=mesh)
            w = whole({"params": new_p, "opt": new_o}, {"params": sh["params"],
                                                         "opt": sh["opt"]})
            out["adamw"][moments] = {"state": w, "grad_norm": float(met["grad_norm"])}


def sh_by(tree, path):
    return dict(flatten_with_paths(tree))[path]


def to_tensors(tree):
    return map_with_paths(lambda _, a: torch.from_numpy(np.array(a)), tree)


def gather_params(tree, sh, mesh):
    by = dict(flatten_with_paths(sh["params"]))
    return {p: by[p].gather(t, mesh).numpy() for p, t in flatten_with_paths(tree)}


def q8_cut_check(out, mesh):
    """A (64, 768) int8 moment on (2, 2) under TRAIN_RULES: the last dim's
    shards of 384 cut the 256-blocks."""
    with sharding.use_mesh(mesh, sharding.TRAIN_RULES):
        g = torch.Generator().manual_seed(5)
        x = torch.randn((64, 768), generator=g)
        ref = adamw.Q8.quantize(x)
        p_sh = sharding.LeafSharding(sharding.param_spec("lm_head/w", x), (64, 768))
        s_sh = sharding.LeafSharding(sharding.param_spec("lm_head/w", ref.scale), (64, 3))
        lay = adamw.Q8Layout(p_sh, s_sh, mesh)
        q = adamw.Q8.quantize(p_sh.shard(x, mesh), lay)
        out["q8_cut"] = {"cuts": adamw.Q8Layout.cuts(p_sh, mesh), "spec": p_sh.spec,
                         "scale_spec": s_sh.spec,
                         "q": torch.equal(p_sh.gather(q.q, mesh), ref.q),
                         "scale": torch.equal(s_sh.gather(q.scale, mesh), ref.scale),
                         "deq": torch.equal(q.dequantize(lay), p_sh.shard(ref.dequantize(), mesh))}


def checkpoint_checks(inp, out, mesh_of, d):
    cfg, tcfg = step_config(*CASES["B"][2:7])
    batch = inp["batch"]
    src, dst = mesh_of((2, 2)), mesh_of((4, 1))
    ck_dir = os.path.join(d, "ckpt_mesh")
    with sharding.use_mesh(src, sharding.TRAIN_RULES):
        sh = state_shardings(cfg, TL, tcfg)
        state = interop.train_state_from_numpy(inp["states"][state_key("int8", True)], "cpu",
                                               shardings=sh)
        state, _ = make_train_step(cfg, TL, tcfg)(state, tensors(batch, local_rows(src, 8, 1)))
        ck = Checkpointer(CheckpointConfig(ck_dir, async_save=False))
        ck.save(1, state, extra={"data_state": {"step": 1, "seed": 0}}, shardings=sh)
        saved = whole(state, sh)
    with sharding.use_mesh(dst, sharding.TRAIN_RULES):
        sh2 = state_shardings(cfg, TL, tcfg)
        by2 = dict(flatten_with_paths(sh2))
        target = init_train_state(None, cfg, TL, tcfg, device="cpu", shardings=sh2)
        restored, extra = Checkpointer(CheckpointConfig(ck_dir)).restore(1, target,
                                                                         shardings=sh2)
        got = whole(restored, sh2)
        out["ckpt"] = {"extra": extra,
                       "restored_equal": all(np.array_equal(got[k], saved[k]) for k in saved)}
        # one more step after the restore, and the same step on the saved
        # state re-sharded in memory
        direct = map_with_paths(
            lambda p, _: by2[p].shard(torch.from_numpy(saved[p]), dst), target)
        rows = tensors(batch, local_rows(dst, 8, 1))
        a, ma = make_train_step(cfg, TL, tcfg)(restored, rows)
        b, mb = make_train_step(cfg, TL, tcfg)(direct, rows)
        wa, wb = whole(a, sh2), whole(b, sh2)
        out["ckpt"]["resume_equal"] = all(np.array_equal(wa[k], wb[k]) for k in wa)
        out["ckpt"]["resume_loss"] = (float(ma["loss"]), float(mb["loss"]))
    # the reference's checkpoint onto (2, 2)
    with sharding.use_mesh(src, sharding.TRAIN_RULES):
        target = init_train_state(None, cfg, TL, tcfg, device="cpu", shardings=sh)
        got, _ = Checkpointer(CheckpointConfig(inp["jax_ckpt"])).restore(0, target,
                                                                         shardings=sh)
        out["ckpt"]["from_reference"] = whole(got, sh)


def moe_checks(inp, out, mesh):
    cfg, tcfg = step_config("f32", "f32", False, False, 1, arch="qwen2-moe-a2.7b")
    with sharding.use_mesh(mesh, sharding.TRAIN_RULES_FSDP):
        sh = state_shardings(cfg, TL, tcfg)
        state = interop.train_state_from_numpy(inp["moe_state"], "cpu", shardings=sh)
        batch = inp["batch"]
        rows = local_rows(mesh, 8, 1)
        state, met = make_train_step(cfg, TL, tcfg)(state, tensors(batch, rows))
        w = whole(state, sh)
        out["moe"] = {"metrics": {k: float(v) for k, v in met.items()},
                      "state": w if mesh.rank == 0 else None}


def watchdog_check(out, mesh, d):
    """A Trainer on (2, 2) whose rank 3 reports every step 1 s slower: each
    rank's watchdog hears every rank's time, so every rank flags rank 3
    after ``grace_steps``, saves the mesh checkpoint and plans the restart
    for the 3 ranks left."""
    from repro_torch.data import SyntheticLM
    from repro_torch.runtime import WatchdogConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg, tcfg = step_config("tnn", "f32", False, True, 1)
    logs = []
    with sharding.use_mesh(mesh, sharding.TRAIN_RULES):
        tr = Trainer(cfg, TL, tcfg, TrainerConfig(
            steps=6, log_every=10**9, checkpoint_every=100,
            checkpoint_dir=os.path.join(d, "ckpt_watchdog"),
            watchdog=WatchdogConfig(straggler_factor=1.5, grace_steps=2)),
            SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=0),
            device="cpu", log_fn=logs.append)
        if mesh.rank == 3:
            beat = tr._heartbeat
            tr._heartbeat = lambda dt: beat(dt + 1.0)
        res = tr.run()
    out["watchdog"] = {"final_step": res.final_step, "plan": res.restart_plan, "logs": logs}


def main(d: str) -> int:
    torch.set_num_threads(2)
    mesh_mod.init_rank("cpu")
    rank = dist.get_rank()
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {"rank": rank, "errors": [], "bytes": {}, "rows": {}, "metrics": {},
           "first_qmm": {}, "states": {}, "ef": {}, "adamw": {}}
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = mesh_mod.make_mesh(shape, ("data", "model"),
                                               device=torch.device("cpu"))
        return meshes[shape]

    for shape in ((2, 2), (1, 4), (4, 1)):
        mesh_of(shape)
    checks = (lambda: step_cases(inp, out, mesh_of),
              lambda: ef_and_adamw_checks(inp, out, mesh_of((2, 2))),
              lambda: q8_cut_check(out, mesh_of((2, 2))),
              lambda: checkpoint_checks(inp, out, mesh_of, d),
              lambda: moe_checks(inp, out, mesh_of((2, 2))),
              lambda: watchdog_check(out, mesh_of((2, 2)), d))
    for check in checks:
        try:
            check()
        except Exception:
            out["errors"].append(traceback.format_exc())
            break
    if rank != 0:
        out["states"] = {}
        out["ef"] = out["adamw"] = {}
        out.get("ckpt", {}).pop("from_reference", None)
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    dist.barrier()
    mesh_mod.shutdown()
    return 0


def launch_main(d: str) -> int:
    """2 ranks: ``launch.train.main`` on the (1, 2) host mesh; rank 0
    saves the losses."""
    from repro_torch.launch import train as launch_train

    torch.set_num_threads(2)
    res = launch_train.main(["--smoke", "--device", "cpu", "--quant", "tnn", "--steps", "6",
                             "--batch", "4", "--seq", "32", "--lr", "3e-3",
                             "--checkpoint-dir", os.path.join(d, "ckpt_launch")])
    if int(os.environ["RANK"]) == 0:
        torch.save({"losses": res.losses, "final_step": res.final_step},
                   os.path.join(d, "launch.pt"))
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "--launch":
        sys.exit(launch_main(sys.argv[2]))
    sys.exit(main(sys.argv[1]))
