"""One rank of the port's tensor- and sequence-parallel training checks
(``tests/test_torch_train_tp.py``).

The test writes the inputs (operands and statistics made with numpy, the
reference's initial train state of a small config, a batch) into a
directory, starts this script as 4 ranks of a gloo world on the CPU
(``launch.mesh.run_ranks``) and holds what each rank writes to
``rank<r>.pt`` against one device.  The script imports neither JAX nor the
JAX package:

    python tests/torch_train_tp_ranks.py <dir>      (RANK, WORLD_SIZE, ... set)

On the (2, 2) ("data", "model") mesh, every rank:

* "a": column- and row-parallel ``quantized_matmul`` forwards (tnn, tbn,
  bnn) with the statistics passed in: its n slice of the output, and its
  sequence shard of the row-parallel sum;
* "b": ``tp_enter`` / ``tp_reduce`` (values and float64 gradients of their
  sequence shards), the vocab-parallel embedding and the vocab-parallel
  loss (value and gradients);
* "c": one train step per case of :data:`CASES` (ruleset, policy), the
  updated state gathered whole on rank 0, and the step's collectives;
* "e": the TRAIN_RULES f32 step once more with the norm scales' gradients
  summed over the batch axes only (the fault (e) must catch).
"""

import os
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import mesh_rows
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model as model_mod
from repro_torch.models.common import ShardLayout
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import sharding
from repro_torch.train import TrainStepConfig, make_train_step
from repro_torch.train.loss import xent_loss
from repro_torch.train.train_step import state_shardings
from repro_torch.tree import flatten_with_paths

SHAPE, SEQ, BATCH, LR = (2, 2), 64, 8, 1e-3
ARCH = "tinyllama-1.1b"
# name: (rules, policy, moments, EF, bf16 wire)
CASES = {
    "train_f32": ("train", "f32", "f32", False, False),
    "train_tnn": ("train", "tnn", "int8", True, True),
    "hybrid_f32": ("train_hybrid", "f32", "f32", False, False),
    "hybrid_tnn": ("train_hybrid", "tnn", "int8", True, True),
    "fsdp_f32": ("train_fsdp", "f32", "f32", False, False),
    "fsdp_tnn": ("train_fsdp", "tnn", "int8", True, True),
}
MODES = ("tnn", "tbn", "bnn")


def config(policy="f32", moments="f32", ef=False, wire=False):
    """The small config (2 layers, d_model 128, 4/2 heads, d_ff 256, vocab
    512, float32 activations, remat) and its step config."""
    cfg = get_smoke(ARCH).with_(d_model=128, d_ff=256, dtype=torch.float32, remat=True,
                                quant_policy=policy)
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=LR, warmup_steps=1, moments_dtype=moments),
                           seq_chunk=32, z_loss=1e-4, ef_compression=ef,
                           cast_params_bf16=wire)
    return cfg, tcfg


def state_key(moments, ef):
    return f"{moments}-{int(ef)}"


def rows_of(mesh):
    """This rank's rows of the global batch under the active rules."""
    coord, shards = sharding.mesh_coord(mesh, sharding.batch_axes())
    return mesh_rows(BATCH, coord, shards, 1)


def seq_shard(t, mesh, dim=1):
    n = t.shape[dim] // mesh.axis_size("model")
    return t.narrow(dim, mesh.axis_index("model") * n, n).contiguous()


def tp_context(mesh):
    """The TRAIN_RULES split of a step of SEQ tokens (heads, FFN and vocab
    over "model", sequence shards)."""
    return sharding.split_batch(mesh, sharding.batch_axes(), tp="model",
                                split=("heads", "ffn", "vocab"), sp=True, seq=SEQ)


def proj_checks(inp, out, mesh):
    """(a): each mode's column- and row-parallel forward at this rank's
    operands, with the one-device statistics passed in."""
    j, tp = mesh.axis_index("model"), mesh.axis_size("model")
    res = {}
    with sharding.use_mesh(mesh, sharding.TRAIN_RULES), tp_context(mesh):
        rows = rows_of(mesh)
        for mode in MODES:
            a = inp["proj"][mode]
            x = torch.from_numpy(a["x"])[rows]                  # (b, S, k) this rank's rows
            b = x.shape[0]
            # column-parallel: the whole sequence, this rank's n slice of w
            w = torch.from_numpy(a["w_col"])
            n = w.shape[1] // tp
            wst = {k: torch.from_numpy(v)[j * n:(j + 1) * n] for k, v in a["wst_col"].items()}
            ast = {k: torch.tensor(v) for k, v in a["ast_col"].items()}
            col = ops.quantized_matmul(x.reshape(-1, x.shape[-1]), w[:, j * n:(j + 1) * n],
                                       mode, "torch", role="col",
                                       stats={"act": ast, "w": wst})
            # row-parallel: this rank's k slice of h and of w
            h = torch.from_numpy(a["h"])[rows]                  # (b, S, k2)
            w2 = torch.from_numpy(a["w_row"])
            k = w2.shape[0] // tp
            wst2 = {kk: torch.from_numpy(v) for kk, v in a["wst_row"].items()}
            ast2 = {kk: torch.tensor(v) for kk, v in a["ast_row"].items()}
            row = ops.quantized_matmul(h[..., j * k:(j + 1) * k].reshape(-1, k),
                                       w2[j * k:(j + 1) * k], mode, "torch", role="row",
                                       lead=(b, SEQ), stats={"act": ast2, "w": wst2})
            res[mode] = {"col": col, "row": row}
    out["a"] = {"rows": rows.tolist(), "model": j, "out": res}


def boundary_checks(inp, out, mesh):
    """(b): the SP boundaries' values and float64 gradients, the
    vocab-parallel embedding and loss."""
    j = mesh.axis_index("model")
    b = inp["bound"]
    res = {}
    with sharding.use_mesh(mesh, sharding.TRAIN_RULES), tp_context(mesh):
        rows = rows_of(mesh)
        x = seq_shard(torch.from_numpy(b["x"])[rows], mesh).requires_grad_(True)
        y = sharding.tp_enter(x)
        (gx,) = torch.autograd.grad((y * torch.from_numpy(b["cot"][j])[rows]).sum(), x)
        res["enter"] = {"y": y.detach(), "gx": gx}
        p = torch.from_numpy(b["part"][j])[rows].requires_grad_(True)
        z = sharding.tp_reduce(p)
        g = seq_shard(torch.from_numpy(b["zcot"])[rows], mesh)
        (gp,) = torch.autograd.grad((z * g).sum(), p)
        res["reduce"] = {"z": z.detach(), "gp": gp}
        cfg = config()[0]
        vl = b["embed"].shape[0] // mesh.axis_size("model")
        table = torch.from_numpy(b["embed"])[j * vl:(j + 1) * vl].requires_grad_(True)
        tokens = torch.from_numpy(b["tokens"])[rows]
        e = model_mod._embed({"embed": table}, {"tokens": tokens}, cfg)
        (ge,) = torch.autograd.grad((e * seq_shard(torch.from_numpy(b["ecot"])[rows],
                                                    mesh)).sum(), table)
        res["embed"] = {"x": e.detach(), "g": ge}
        hidden = seq_shard(torch.from_numpy(b["hidden"])[rows], mesh).requires_grad_(True)
        head = torch.from_numpy(b["head"])[:, j * vl:(j + 1) * vl].requires_grad_(True)
        batch = {"labels": torch.from_numpy(b["labels"])[rows],
                 "mask": torch.from_numpy(b["mask"])[rows]}
        loss, met = xent_loss({"lm_head": {"w": head}}, hidden, batch, cfg, ShardLayout(),
                              seq_chunk=32, z_loss=1e-4)
        total = sharding.sum_over_batch(loss)
        gh, gw = torch.autograd.grad(total, (hidden, head))
        res["loss"] = {"loss": float(total), "nll": float(sharding.sum_over_batch(met["nll"])),
                       "tokens": float(met["tokens"]), "g_hidden": gh, "g_head": gw}
    out["b"] = {"rows": rows.tolist(), "model": j, "out": res}


def step_checks(inp, out, mesh, names=CASES, fault=False):
    """(c), and with ``fault`` (e): one step per case."""
    for name in names:
        rules, policy, moments, ef, wire = CASES[name]
        cfg, tcfg = config(policy, moments, ef, wire)
        layout = ShardLayout()
        with sharding.use_mesh(mesh, sharding.RULESETS[rules]):
            sh = state_shardings(cfg, layout, tcfg)
            state = interop.train_state_from_numpy(inp["states"][state_key(moments, ef)], "cpu",
                                                   shardings=sh)
            rows = rows_of(mesh)
            batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
                     for k, v in inp["batch"].items()}
            mesh_mod.reset_collectives()
            state, met = make_train_step(cfg, layout, tcfg)(state, batch)
            coll = {k: v for k, v in mesh_mod.collectives().items() if not k.endswith("_s")}
            whole = dict(flatten_with_paths(interop.train_state_to_numpy(state, sh)))
        key = "e" if fault else "c"
        out[key][name] = {"metrics": {k: float(v) for k, v in met.items()},
                          "collectives": coll, "state": whole if mesh.rank == 0 else None}


def skip_model_sum():
    """The fault of (e): leaf plans whose whole leaves sum their gradients
    over the batch axes only."""
    real = sharding.leaf_plans

    def faulty(p_sh, ctx=None, *, sp):
        plans, split = real(p_sh, ctx, sp=sp)
        from repro_torch import tree

        return tree.tree_map(lambda pl: pl if pl.split else sharding.LeafPlan(
            pl.gather, tuple(a for a in pl.sum_axes if a != "model")), plans), split
    sharding.leaf_plans = faulty
    return real


def main(d: str) -> int:
    torch.set_num_threads(1)
    mesh_mod.init_rank("cpu")
    rank = dist.get_rank()
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    mesh = mesh_mod.make_mesh(SHAPE, ("data", "model"), device=torch.device("cpu"))
    out = {"rank": rank, "coords": dict(mesh.coords), "errors": [], "c": {}, "e": {}}
    checks = (lambda: proj_checks(inp, out, mesh),
              lambda: boundary_checks(inp, out, mesh),
              lambda: step_checks(inp, out, mesh))
    for check in checks:
        try:
            check()
        except Exception:
            out["errors"].append(traceback.format_exc())
    real = skip_model_sum()
    try:
        step_checks(inp, out, mesh, names=("train_f32",), fault=True)
    except Exception:
        out["errors"].append(traceback.format_exc())
    finally:
        sharding.leaf_plans = real
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    dist.barrier()
    mesh_mod.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
