"""One rank of the port's tensor-parallel INT8/INT4 training checks
(``tests/test_torch_train_tp_affine.py``).

The test writes the inputs (operands made with numpy, layer parameters,
the reference's initial train states of the small configs of
:data:`ARCHS`, a batch) into a directory, starts this script as 4 ranks
of a gloo world on the CPU (``launch.mesh.run_ranks``) and holds what
each rank writes to ``rank<r>.pt`` against one device.  The script
imports neither JAX nor the JAX package:

    python tests/torch_train_tp_affine_ranks.py <dir>      (RANK, WORLD_SIZE, ... set)
    python tests/torch_train_tp_affine_ranks.py --launch <dir>

On the (2, 2) ("data", "model") mesh under TRAIN_RULES' split, every
rank, for each mode of :data:`MODES`:

* "a": the statistics the split derives: a column-parallel input's range
  over "data", a row-parallel input's over "data" and "model", a
  column- and a row-parallel weight's grid over "model", every expert's
  grids in one collective each (the count of collectives kept), and the
  grid of Mamba2's whole ``in_proj`` that ``ssm_forward`` passes to its
  column-parallel projection;
* "b": with one device's statistics passed in: the column-parallel
  output on its n slice, the row-parallel output's rows it keeps, its
  int32 partial eq. (3) cores (a k slice of 128, and an odd one of 33),
  the experts' column-parallel outputs and their ``row_parallel_group``
  outputs, Mamba2's ``in_proj`` on its heads' columns;
* "c": one train step per (arch, case) of :data:`RUNS`, the updated state
  gathered whole on rank 0, and the step's collectives;
* "d": the fault: each rank calibrates an affine weight on its own chunk
  (no max over "model"): (a)'s weight grids and (c)'s dense step again;

``--launch <dir>`` (4 ranks), (e): ``launch.train --quant int8`` and
``--quant int4``, 2 steps each on the (2, 2) mesh in place of the
launcher's (1, 4) host mesh; rank 0 keeps the losses.
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
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import train_layout
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import qmm_mesh, sharding
from repro_torch.train import TrainStepConfig, make_train_step
from repro_torch.train.train_step import state_shardings
from repro_torch.tree import flatten_with_paths

SHAPE, SEQ, BATCH, LR = (2, 2), 64, 8, 1e-3
# the small configs, float32 activations and remat: TinyLlama's smoke at
# d_model 128, d_ff 256, vocab 512; Qwen2-MoE's and Mamba2's as
# tests/test_torch_train_tp_moe_ssm.py builds them
ARCHS = {"tinyllama-1.1b": {"d_model": 128, "d_ff": 256},
         "qwen2-moe-a2.7b": {"d_ff": 128, "shared_expert_d_ff": 256},
         "mamba2-1.3b": {}}
MODES = ("int8", "int4")
# name: (arch, rules, policy); f32 moments, no EF, float32 compute copies
RUNS = {
    "dense_int8": ("tinyllama-1.1b", "train", "int8"),
    "dense_int4": ("tinyllama-1.1b", "train", "int4"),
    "dense_hybrid_int8": ("tinyllama-1.1b", "train_hybrid", "int8"),
    "moe_int8": ("qwen2-moe-a2.7b", "train", "int8"),
    "ssm_int4": ("mamba2-1.3b", "train", "int4"),
}
FAULT_RUN = "dense_int8"
# the operands of "a" / "b": experts, their rows, model width, ffn width;
# the odd row-parallel depth (33 a rank)
EXPERTS, ROWS, D_IN, D_FF = 4, 48, 64, 128
K_ODD = 66
LAUNCH_ARGS = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "8", "--seq", "32",
               "--lr", "3e-3"]


def config(arch, policy="f32"):
    """The small config of ``arch`` and the step config (f32 moments, no
    EF, float32 compute copies)."""
    cfg = get_smoke(arch).with_(dtype=torch.float32, remat=True, quant_policy=policy,
                                **ARCHS[arch])
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=LR, warmup_steps=1), seq_chunk=32,
                           z_loss=1e-4)
    return cfg, tcfg


def rows_of(mesh, n=BATCH):
    """This rank's rows of ``n`` global rows under the active rules."""
    coord, shards = sharding.mesh_coord(mesh, sharding.batch_axes())
    return mesh_rows(n, coord, shards, 1)


def chunk(t, mesh, dim):
    """This rank's "model" chunk of ``t`` along ``dim``."""
    n = t.shape[dim] // mesh.axis_size("model")
    return t.narrow(dim, mesh.axis_index("model") * n, n).contiguous()


def tp_context(mesh):
    """The TRAIN_RULES split of a step of SEQ tokens."""
    return sharding.split_batch(mesh, sharding.batch_axes(), tp="model",
                                split=("heads", "ffn", "vocab", "ssm_heads"), sp=True, seq=SEQ)


def st(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _all_reduces(fn):
    """``fn()`` and the all-reduces it made."""
    mesh_mod.reset_collectives()
    out = fn()
    return out, mesh_mod.collectives().get("all_reduce", 0)


def stat_checks(inp, out, mesh, key="a"):
    """(a): the statistics this rank's split derives."""
    res = {}
    with sharding.use_mesh(mesh, sharding.TRAIN_RULES), tp_context(mesh):
        split = sharding.tp_split()
        rows = rows_of(mesh)
        erows = rows_of(mesh, ROWS)
        for mode in MODES:
            a = inp["proj"][mode]
            x = torch.from_numpy(a["x"])[rows]
            h = chunk(torch.from_numpy(a["h"])[rows], mesh, 2)
            r = {"act_col": ops.split_batch_stats(x.reshape(-1, x.shape[-1]), mode, split),
                 "act_row": ops.split_batch_stats(h.reshape(-1, h.shape[-1]), mode, split,
                                                  over_tp=True),
                 "w_col": ops.split_weight_stats(chunk(torch.from_numpy(a["w_col"]), mesh, 1),
                                                 mode, split),
                 "w_row": ops.split_weight_stats(chunk(torch.from_numpy(a["w_row"]), mesh, 0),
                                                 mode, split)}
            e = inp["experts"][mode]
            r["experts_w_col"], r["experts_w_col_reduces"] = _all_reduces(
                lambda: ops.split_weight_stats_many(
                    [chunk(w, mesh, 1) for w in torch.from_numpy(e["w_col"])], mode, split))
            r["experts_w_row"], r["experts_w_row_reduces"] = _all_reduces(
                lambda: ops.split_weight_stats_many(
                    [chunk(w, mesh, 0) for w in torch.from_numpy(e["w_row"])], mode, split))
            r["experts_act"], r["experts_act_reduces"] = _all_reduces(
                lambda: ops.split_batch_stats_many(
                    [x[erows] for x in torch.from_numpy(e["x"])], mode, split))
            r["in_proj"] = in_proj_stats(inp, mesh, mode)
            res[mode] = r
    out[key] = {"model": mesh.axis_index("model"), "out": res}


def in_proj_stats(inp, mesh, mode):
    """The weight statistics ``ssm_forward`` passes to its column-parallel
    ``in_proj`` on this rank's heads, and the all-reduces of that
    projection's call (its activations' range over "data" only)."""
    cfg = config("mamba2-1.3b", mode)[0]
    lay = inp["ssm_layer"]
    params = {k: torch.from_numpy(v) for k, v in lay["params"].items() if "/" not in k}
    params["in_proj"] = {"w": torch.from_numpy(lay["params"]["in_proj/w"])}
    params["out_proj"] = {"w": chunk(torch.from_numpy(lay["params"]["out_proj/w"]), mesh, 0)}
    for k in ("A_log", "D", "dt_bias", "norm"):
        params[k] = chunk(params[k], mesh, 0)
    x = chunk(torch.from_numpy(lay["x"])[rows_of(mesh)], mesh, 1)
    seen = []
    real = ops.quantized_matmul

    def record(xx, w, mode_, backend="cuda", *, role=None, lead=None, stats=None):
        if not seen:
            seen.append({"w": stats["w"]})
            mesh_mod.reset_collectives()
        y = real(xx, w, mode_, backend, role=role, lead=lead, stats=stats)
        if len(seen) == 1 and "reduces" not in seen[0]:
            seen[0]["reduces"] = mesh_mod.collectives().get("all_reduce", 0)
        return y

    ops.quantized_matmul = record
    try:
        with torch.no_grad():
            ssm_mod.ssm_forward(params, x, cfg, cfg.policy)
    finally:
        ops.quantized_matmul = real
    return seen[0]


def proj_checks(inp, out, mesh):
    """(b): each mode's projections at this rank's operands, with one
    device's statistics passed in."""
    res = {}
    cfg = config("mamba2-1.3b")[0]
    with sharding.use_mesh(mesh, sharding.TRAIN_RULES), tp_context(mesh):
        split = sharding.tp_split()
        j, tp = mesh.axis_index("model"), mesh.axis_size("model")
        rows = rows_of(mesh)
        _, cols, _ = ssm_mod._tp_dims(cfg, tp, j, torch.device("cpu"))
        for mode in MODES:
            a, s = inp["proj"][mode], inp["stats"][mode]
            x = torch.from_numpy(a["x"])[rows]
            b = x.shape[0]
            col = ops.quantized_matmul(x.reshape(-1, x.shape[-1]),
                                       chunk(torch.from_numpy(a["w_col"]), mesh, 1), mode,
                                       "torch", role="col",
                                       stats={"act": st(s["act_col"]), "w": st(s["w_col"])})
            h = torch.from_numpy(a["h"])[rows]
            hk = chunk(h, mesh, 2).reshape(-1, h.shape[-1] // tp)
            wk = chunk(torch.from_numpy(a["w_row"]), mesh, 0)
            row_stats = {"act": st(s["act_row"]), "w": st(s["w_row"])}
            row = ops.quantized_matmul(hk, wk, mode, "torch", role="row", lead=(b, SEQ),
                                       stats=row_stats)
            parts = {"row": partial(hk, wk, mode, split, row_stats)}
            ho = chunk(torch.from_numpy(a["h_odd"])[rows], mesh, 2)
            parts["odd"] = partial(ho.reshape(-1, ho.shape[-1]),
                                   chunk(torch.from_numpy(a["w_odd"]), mesh, 0), mode, split,
                                   {"act": st(s["act_odd"]), "w": st(s["w_odd"])})
            e, es = inp["experts"][mode], inp["expert_stats"][mode]
            ex, ewc = torch.from_numpy(e["x"]), torch.from_numpy(e["w_col"])
            eh, ewr = torch.from_numpy(e["h"]), torch.from_numpy(e["w_row"])
            ecol = [ops.quantized_matmul(ex[i], chunk(ewc[i], mesh, 1), mode, "torch",
                                         role="col", stats={"act": st(es["act_col"][i]),
                                                            "w": st(es["w_col"][i])})
                    for i in range(EXPERTS)]
            erow = ops.row_parallel_group(
                [chunk(eh[i], mesh, 1) for i in range(EXPERTS)],
                [chunk(ewr[i], mesh, 0) for i in range(EXPERTS)], mode, "torch",
                stats=[{"act": st(es["act_row"][i]), "w": st(es["w_row"][i])}
                       for i in range(EXPERTS)])
            sp = inp["ssm_proj"][mode]
            in_proj = ops.quantized_matmul(
                torch.from_numpy(sp["x"]), torch.from_numpy(sp["w"])[:, cols], mode, "torch",
                role="col", stats={"act": st(sp["act"]), "w": st(sp["wst"])})
            res[mode] = {"col": col, "row": row, "partials": parts, "experts_col": ecol,
                         "experts_row": erow, "in_proj": in_proj, "cols": cols}
    out["b"] = {"rows": rows.tolist(), "model": j, "out": res}


def partial(x, w, mode, split, stats):
    """This rank's int32 partial eq. (3) core of a row-parallel projection
    on its k slice (``ops._row_operands`` and
    ``qmm_mesh.k_sharded_partial``), before the sum over "model"."""
    a_pl, planes, part_kw, _ = ops._row_operands(x, w, ops.QuantMode(mode), "torch", split,
                                                 stats)
    return qmm_mesh.k_sharded_partial(a_pl, planes, **part_kw)


def step_checks(inp, out, mesh, names, key="c"):
    """(c), and for the fault (d): one step per run."""
    for name in names:
        arch, rules, policy = RUNS[name]
        cfg, tcfg = config(arch, policy)
        with sharding.use_mesh(mesh, sharding.RULESETS[rules]):
            layout = train_layout()
            sh = state_shardings(cfg, layout, tcfg)
            state = interop.train_state_from_numpy(inp["states"][arch], "cpu", shardings=sh)
            rows = rows_of(mesh)
            batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
                     for k, v in inp["batch"].items()}
            mesh_mod.reset_collectives()
            state, met = make_train_step(cfg, layout, tcfg)(state, batch)
            coll = {k: v for k, v in mesh_mod.collectives().items() if not k.endswith("_s")}
            whole = dict(flatten_with_paths(interop.train_state_to_numpy(state, sh)))
        out[key][name] = {"metrics": {k: float(v) for k, v in met.items()},
                          "collectives": coll, "state": whole if mesh.rank == 0 else None}


def chunk_local_grid():
    """The fault of (d): an affine weight's grid from this rank's chunk
    alone (no max over "model").  Returns the undo."""
    real = ops.split_weight_stats_many

    def faulty(ws, mode, split):
        if ops.QuantMode(mode) in (ops.QuantMode.INT8, ops.QuantMode.INT4):
            return [ops.affine_weight_stats(w, ops.QuantMode(mode)) for w in ws]
        return real(ws, mode, split)

    ops.split_weight_stats_many = faulty

    def undo():
        ops.split_weight_stats_many = real
    return undo


def launch_main(d: str) -> int:
    """(e), ``--launch``: ``launch.train.main`` for each mode on the (2, 2)
    mesh (in place of the launcher's (1, 4) host mesh), each joining the
    world at a rendezvous of its own; rank 0 saves the losses."""
    from repro_torch.launch import train as launch_train

    torch.set_num_threads(1)
    store = os.environ[mesh_mod.STORE_ENV]
    mesh_mod.make_host_mesh = lambda device=None: mesh_mod.make_mesh(
        SHAPE, ("data", "model"), device=device)
    out = {}
    for mode in MODES:
        os.environ[mesh_mod.STORE_ENV] = f"{store}.{mode}"
        res = launch_train.main(LAUNCH_ARGS + ["--quant", mode])
        out[mode] = {"losses": res.losses, "final_step": res.final_step}
    if os.environ["RANK"] == "0":
        torch.save(out, os.path.join(d, "launch.pt"))
    return 0


def main(d: str) -> int:
    torch.set_num_threads(1)
    mesh_mod.init_rank("cpu")
    rank = dist.get_rank()
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    mesh = mesh_mod.make_mesh(SHAPE, ("data", "model"), device=torch.device("cpu"))
    out = {"rank": rank, "coords": dict(mesh.coords), "errors": [], "c": {}, "d": {"c": {}}}
    checks = (lambda: stat_checks(inp, out, mesh),
              lambda: proj_checks(inp, out, mesh),
              lambda: step_checks(inp, out, mesh, RUNS))
    for check in checks:
        try:
            check()
        except Exception:
            out["errors"].append(traceback.format_exc())
    undo = chunk_local_grid()
    try:
        stat_checks(inp, out["d"], mesh, key="a")
        step_checks(inp, out["d"], mesh, [FAULT_RUN], key="c")
    except Exception:
        out["errors"].append(traceback.format_exc())
    finally:
        undo()
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    dist.barrier()
    mesh_mod.shutdown()
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "--launch":
        sys.exit(launch_main(sys.argv[2]))
    sys.exit(main(sys.argv[1]))
