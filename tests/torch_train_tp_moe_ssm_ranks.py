"""One rank of the port's tensor-parallel MoE and Mamba2 training checks
(``tests/test_torch_train_tp_moe_ssm.py``).

The test writes the inputs (operands, statistics and layer parameters
made with numpy, the reference's initial train states of the small
configs of :data:`ARCHS`, a batch) into a directory, starts this script
as 4 ranks of a gloo world on the CPU (``launch.mesh.run_ranks``) and
holds what each rank writes to ``rank<r>.pt`` against one device.  The
script imports neither JAX nor the JAX package:

    python tests/torch_train_tp_moe_ssm_ranks.py <dir>      (RANK, WORLD_SIZE, ... set)
    python tests/torch_train_tp_moe_ssm_ranks.py --gpu <dir>

``--gpu`` (``tests/test_torch_kernels_gpu.py``, 2 ranks on the card): the
tensor-parallel ``tnn`` forward of the small Qwen2-MoE and Mamba2 layers
on the (1, 2) mesh, through the card's kernels and through their plain
versions (``quant_backend="torch"``), written to ``gpu_rank<r>.json``.

On the (2, 2) ("data", "model") mesh, every rank:

* "a": per mode (tnn, tbn, bnn), with the statistics passed in: the
  experts' column-parallel ``quantized_matmul`` on its ffn slice, their
  row-parallel ``ops.row_parallel_group`` on its k slice (one
  all-reduce), and the Mamba2 ``in_proj`` on its heads' columns;
* "b": under TRAIN_RULES' split (sequence shards), ``moe_ffn`` and
  ``ssm_forward`` (f32) on its rows, sequence shard and chunks: their
  output, aux loss and the gradients of their input and leaves;
* "c": one train step per arch and case of :data:`CASES`, the updated
  state gathered whole on rank 0, and the step's collectives;
* "e": the faults the test must catch: Mamba2's TRAIN_RULES f32 step
  with the gated norm's sum of squares not summed over "model", and
  Qwen2-MoE's TRAIN_RULES_HYBRID f32 step whose router sums its gradient
  over "model" too.
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
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import train_layout
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import sharding
from repro_torch.train import TrainStepConfig, make_train_step
from repro_torch.train.train_step import state_shardings
from repro_torch.tree import flatten_with_paths, tree_map

SHAPE, SEQ, BATCH, LR = (2, 2), 64, 8, 1e-3
# the small configs: every rank's ffn and d_inner slices whole 32-bit words
ARCHS = {"qwen2-moe-a2.7b": {"d_ff": 128, "shared_expert_d_ff": 256},
         "mamba2-1.3b": {},
         "jamba-1.5-large-398b": {}}
# name: (rules, policy, moments, EF, bf16 wire)
CASES = {
    "train_f32": ("train", "f32", "f32", False, False),
    "hybrid_f32": ("train_hybrid", "f32", "f32", False, False),
    "train_tnn": ("train", "tnn", "int8", True, True),
}
# (arch, case) of the faulty steps of "e"
FAULTS = {"norm": ("mamba2-1.3b", "train_f32"), "router": ("qwen2-moe-a2.7b", "hybrid_f32")}
MODES = ("tnn", "tbn", "bnn")
# the operands of "a": experts, their rows, model width, ffn width
EXPERTS, ROWS, D_IN, D_FF = 4, 48, 64, 128


def config(arch, policy="f32", moments="f32", ef=False, wire=False):
    """The small config of ``arch`` (float32 activations, remat) and its
    step config."""
    cfg = get_smoke(arch).with_(dtype=torch.float32, remat=True, quant_policy=policy,
                                **ARCHS[arch])
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=LR, warmup_steps=1, moments_dtype=moments),
                           seq_chunk=32, z_loss=1e-4, ef_compression=ef,
                           cast_params_bf16=wire)
    return cfg, tcfg


def state_key(arch, moments, ef):
    return f"{arch}-{moments}-{int(ef)}"


def rows_of(mesh):
    """This rank's rows of the global batch under the active rules."""
    coord, shards = sharding.mesh_coord(mesh, sharding.batch_axes())
    return mesh_rows(BATCH, coord, shards, 1)


def seq_shard(t, mesh, dim=1):
    n = t.shape[dim] // mesh.axis_size("model")
    return t.narrow(dim, mesh.axis_index("model") * n, n).contiguous()


def chunk(t, mesh, dim):
    """This rank's "model" chunk of ``t`` along ``dim``."""
    n = t.shape[dim] // mesh.axis_size("model")
    return t.narrow(dim, mesh.axis_index("model") * n, n).contiguous()


def tp_context(mesh, split=("heads", "ffn", "vocab", "ssm_heads")):
    """The TRAIN_RULES split of a step of SEQ tokens."""
    return sharding.split_batch(mesh, sharding.batch_axes(), tp="model", split=split, sp=True,
                                seq=SEQ)


def st(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def proj_checks(inp, out, mesh):
    """(a): each mode's expert and in_proj projections at this rank's
    slices, with one device's statistics passed in."""
    res = {}
    cfg = config("mamba2-1.3b")[0]
    with sharding.use_mesh(mesh, sharding.TRAIN_RULES), tp_context(mesh):
        j, tp = mesh.axis_index("model"), mesh.axis_size("model")
        _, cols, _ = ssm_mod._tp_dims(cfg, tp, j, torch.device("cpu"))
        for mode in MODES:
            a = inp["proj"][mode]
            x, wc = torch.from_numpy(a["x"]), torch.from_numpy(a["w_col"])
            h, wr = torch.from_numpy(a["h"]), torch.from_numpy(a["w_row"])
            col = [ops.quantized_matmul(x[e], chunk(wc[e], mesh, 1), mode, "torch", role="col",
                                        stats={"act": st(a["ast_col"][e]),
                                               "w": {k: chunk(torch.from_numpy(v), mesh, 0)
                                                     for k, v in a["wst_col"][e].items()}})
                   for e in range(EXPERTS)]
            row = ops.row_parallel_group(
                [chunk(h[e], mesh, 1) for e in range(EXPERTS)],
                [chunk(wr[e], mesh, 0) for e in range(EXPERTS)], mode, "torch",
                stats=[{"act": st(a["ast_row"][e]), "w": st(a["wst_row"][e])}
                       for e in range(EXPERTS)])
            s = inp["ssm_proj"][mode]
            w_in = torch.from_numpy(s["w"])
            in_proj = ops.quantized_matmul(
                torch.from_numpy(s["x"]), w_in[:, cols], mode, "torch", role="col",
                stats={"act": st(s["ast"]), "w": {k: torch.from_numpy(v)[cols]
                                                  for k, v in s["wst"].items()}})
            res[mode] = {"col": col, "row": row, "in_proj": in_proj, "cols": cols}
    out["a"] = {"model": j, "out": res}


def layer_checks(inp, out, mesh):
    """(b): moe_ffn and ssm_forward (f32) on this rank's rows, sequence
    shard and chunks, under TRAIN_RULES' split: output, aux, gradients."""
    res = {}
    with sharding.use_mesh(mesh, sharding.TRAIN_RULES), tp_context(mesh):
        rows = rows_of(mesh)
        for arch, fn in (("qwen2-moe-a2.7b", "moe"), ("mamba2-1.3b", "ssm")):
            cfg = config(arch)[0]
            lay = inp["layers"][fn]
            x = seq_shard(torch.from_numpy(lay["x"])[rows], mesh).requires_grad_(True)
            cot = seq_shard(torch.from_numpy(lay["cot"])[rows], mesh)
            whole = tree_map(torch.from_numpy, lay["params"])
            local = {p: chunk(t, mesh, lay["dims"][p]) if p in lay["dims"] else t.clone()
                     for p, t in flatten_with_paths(whole)}
            params = _unflatten(local)
            leaves = [t.requires_grad_(True) for t in _leaves(params)]
            if fn == "moe":
                y, aux = moe_mod.moe_ffn(params, x, cfg, cfg.policy)
                total = (y * cot).sum() + aux
            else:
                y = ssm_mod.ssm_forward(params, x, cfg, cfg.policy)
                aux = torch.zeros(())
                total = (y * cot).sum()
            grads = torch.autograd.grad(total, [x] + leaves)
            res[fn] = {"y": y.detach(), "aux": float(aux), "gx": grads[0],
                       "grads": {p: g for (p, _), g in zip(flatten_with_paths(params), grads[1:])}}
    out["b"] = {"rows": rows.tolist(), "model": mesh.axis_index("model"), "out": res}


def _unflatten(flat):
    tree = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def _leaves(tree):
    return [t for _, t in flatten_with_paths(tree)]


def step_checks(inp, out, mesh, runs, key="c"):
    """(c), and for the faults (e): one step per (arch, case)."""
    for arch, name in runs:
        rules, policy, moments, ef, wire = CASES[name]
        cfg, tcfg = config(arch, policy, moments, ef, wire)
        with sharding.use_mesh(mesh, sharding.RULESETS[rules]):
            layout = train_layout()
            sh = state_shardings(cfg, layout, tcfg)
            state = interop.train_state_from_numpy(inp["states"][state_key(arch, moments, ef)],
                                                   "cpu", shardings=sh)
            rows = rows_of(mesh)
            batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
                     for k, v in inp["batch"].items()}
            mesh_mod.reset_collectives()
            state, met = make_train_step(cfg, layout, tcfg)(state, batch)
            coll = {k: v for k, v in mesh_mod.collectives().items() if not k.endswith("_s")}
            whole = dict(flatten_with_paths(interop.train_state_to_numpy(state, sh)))
        out[key][f"{arch}/{name}"] = {"metrics": {k: float(v) for k, v in met.items()},
                                      "collectives": coll,
                                      "state": whole if mesh.rank == 0 else None}


def fault(kind):
    """The faults of (e): "norm", the gated norm's sum of squares summed
    over nothing; "router", every leaf that keeps no chunk summing its
    gradient over "model" too (the router counted twice under
    TRAIN_RULES_HYBRID).  Returns the undo."""
    if kind == "norm":
        real = sharding.tp_all_reduce
        sharding.tp_all_reduce = lambda t: t

        def undo():
            sharding.tp_all_reduce = real
        return undo
    real = sharding.leaf_plans

    def faulty(p_sh, ctx=None, *, sp):
        from repro_torch import tree

        plans, split = real(p_sh, ctx, sp=sp)
        tp = sharding.tp_axis(ctx)
        return tree.tree_map(lambda pl: pl if pl.split or tp in pl.sum_axes else
                             sharding.LeafPlan(pl.gather, pl.sum_axes + (tp,)), plans), split
    sharding.leaf_plans = faulty

    def undo():
        sharding.leaf_plans = real
    return undo


def main(d: str) -> int:
    torch.set_num_threads(1)
    mesh_mod.init_rank("cpu")
    rank = dist.get_rank()
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    mesh = mesh_mod.make_mesh(SHAPE, ("data", "model"), device=torch.device("cpu"))
    out = {"rank": rank, "coords": dict(mesh.coords), "errors": [], "c": {}, "e": {}}
    checks = (lambda: proj_checks(inp, out, mesh),
              lambda: layer_checks(inp, out, mesh),
              lambda: step_checks(inp, out, mesh, [(a, c) for a in ARCHS for c in CASES]))
    for check in checks:
        try:
            check()
        except Exception:
            out["errors"].append(traceback.format_exc())
    for kind, run in FAULTS.items():
        undo = fault(kind)
        try:
            step_checks(inp, out, mesh, [run], key="e")
        except Exception:
            out["errors"].append(traceback.format_exc())
        finally:
            undo()
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    dist.barrier()
    mesh_mod.shutdown()
    return 0


def gpu_main(d: str) -> int:
    """``--gpu``: each rank's tnn MoE and SSM layer forward on its (1, 2)
    slices, on the card's kernels and on their plain versions; equal
    outputs and the launches of the kernel run."""
    import json

    from repro_torch.kernels import _build

    torch.use_deterministic_algorithms(True)
    dev = mesh_mod.init_rank("cuda")
    mesh = mesh_mod.make_mesh((1, 2), ("data", "model"), device=dev)
    rep = {"rank": dist.get_rank(), "backend": mesh.backend}
    with sharding.use_mesh(mesh, sharding.TRAIN_RULES), tp_context(mesh):
        for arch, fn in (("qwen2-moe-a2.7b", "moe"), ("mamba2-1.3b", "ssm")):
            cfg = config(arch, "tnn")[0]
            gen = torch.Generator(device=dev).manual_seed(3)
            if fn == "moe":
                p = moe_mod.init_moe(gen, cfg, device=dev)
                dims = {"gate/w": 2, "up/w": 2, "down/w": 1, "shared/gate/w": 1,
                        "shared/up/w": 1, "shared/down/w": 0}
            else:
                p = ssm_mod.init_ssm(gen, cfg, device=dev)
                dims = {"A_log": 0, "D": 0, "dt_bias": 0, "norm": 0, "out_proj/w": 0}
            params = _unflatten({path: chunk(t, mesh, dims[path]) if path in dims else t
                                 for path, t in flatten_with_paths(p)})
            x = torch.randn((2, SEQ, cfg.d_model), generator=gen, device=dev)
            x = seq_shard(x, mesh)
            outs = {}
            for backend in ("cuda", "torch"):
                c = cfg.with_(quant_backend=backend)
                _build.reset_launches()
                with torch.no_grad():
                    if fn == "moe":
                        outs[backend] = moe_mod.moe_ffn(params, x, c, c.policy)[0]
                    else:
                        outs[backend] = ssm_mod.ssm_forward(params, x, c, c.policy)
                torch.cuda.synchronize()
                if backend == "cuda":
                    rep[f"{fn}_launches"] = _build.launches()
            rep[f"{fn}_equal"] = bool(torch.equal(outs["cuda"], outs["torch"]))
            rep[f"{fn}_finite"] = bool(torch.isfinite(outs["cuda"]).all())
    with open(os.path.join(d, f"gpu_rank{rep['rank']}.json"), "w") as f:
        json.dump(rep, f)
    dist.barrier()
    mesh_mod.shutdown()
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "--gpu":
        sys.exit(gpu_main(sys.argv[2]))
    sys.exit(main(sys.argv[1]))
