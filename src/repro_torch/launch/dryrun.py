"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on ``meta``
tensors, as one rank of a placeholder mesh, and count what it does.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell on 512 forced host devices and parses the compiled
HLO; the port has nothing to compile, so each cell runs its real step
(``launch/specs.py``) on ``meta`` tensors at one rank's local shapes,
under a :class:`~repro_torch.launch.mesh.PlaceholderMesh` ((16, 16)
"pod", 256 GPUs, or (2, 16, 16) "multipod", 512) and
``roofline.op_stats.counting``.  Nothing runs on a device and nothing is
timed but the trace itself.

Per cell (in a subprocess, so each cell gets a fresh process):

    with use_mesh(PlaceholderMesh(...), rules):
        art = cell_artifacts(cfg, shape)         # meta tensors only
        with counting(art.args) as stats:
            art.step_fn(*art.args)

and one JSON record, in the reference's schema where it carries over:
``status``, ``memory`` (argument / output / temp bytes: the arguments'
storages, the outputs' new storages, the peak of live storage beyond the
arguments), ``cost`` (``flops``: the float products; ``bytes accessed``:
``op_stats``' HBM estimate, kernels included), ``static``
(``OpStats.as_dict``: products by dtype, kernel records and their work,
collectives per axis, operations by class), ``collectives`` (bytes per
kind, counts), ``collective_ops`` (the ordered schedule, first 40), and
``trace_s`` (seconds to build the arguments and run the step) in place of
``lower_s`` / ``compile_s``.  A failure is recorded, not raised: the
matrix finishes.  Not ported: ``_cpu_f32_artifact_bytes`` (an XLA:CPU
float-normalization artifact; nothing is compiled here) and
``collectives_optimized`` (there is no second, optimized executable: the
schedule is the one the step runs).

Records land in experiments/dryrun_torch/<mesh>/<arch>__<shape>.json;
``roofline.analysis.roofline_from_artifact`` reads them.

Usage:
    python -m repro_torch.launch.dryrun                      # every cell, both meshes
    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --mesh pod
    python -m repro_torch.launch.dryrun --arch mixtral-8x22b --shape train_4k
    python -m repro_torch.launch.dryrun --force              # ignore cached records
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, Optional

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
# first entries of the schedule kept in a record
SCHEDULE_LIMIT = 40


def _config(arch: str, quant: Optional[str]):
    from repro_torch.configs import get_config

    over = {}
    for tok in (quant.split("+") if quant else []):
        if tok == "kv8":
            over["kv_cache_dtype"] = "int8"
        elif tok == "kvt2":
            over["kv_cache_dtype"] = "tnn2"     # the paged ternary KV cache
        elif tok == "noremat":
            over["remat"] = False
        elif tok:
            over["quant_policy"] = tok
    return get_config(arch, **over)


def _rules(kind: str, cfg, ruleset: Optional[str]):
    from repro_torch.parallel import sharding

    if ruleset:
        return sharding.RULESETS[ruleset]
    if kind == "decode" and cfg.num_experts:
        return sharding.SERVE_RULES_MOE      # expert weights must fit
    return {"train": sharding.TRAIN_RULES, "prefill": sharding.PREFILL_RULES,
            "decode": sharding.SERVE_RULES}[kind]


def _schedule(ops, limit: int = SCHEDULE_LIMIT):
    if len(ops) > limit:
        return ops[:limit] + [f"... (+{len(ops) - limit} more)"]
    return list(ops)


# --------------------------------------------------------------------------
# single-cell worker (runs in its own process)
# --------------------------------------------------------------------------

def run_cell_here(arch: str, shape_name: str, mesh_name: str, out_path: Optional[str],
                  quant: Optional[str] = None, ruleset: Optional[str] = None) -> Dict:
    """Trace one cell in this process, on the placeholder ``mesh_name``
    mesh's rank 0, and write its record to ``out_path`` (None: return it
    only)."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import cell_artifacts
    from repro_torch.parallel import sharding
    from repro_torch.roofline import op_stats

    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "quant": quant,
           "ruleset": ruleset, "status": "FAIL"}
    t0 = time.time()
    try:
        cfg = _config(arch, quant)
        shape = SHAPES[shape_name]
        mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"), placeholder=True)
        rec.update({"quant": quant or cfg.quant_policy, "ruleset": ruleset or shape.kind,
                    "mesh_shape": list(mesh.shape), "num_devices": int(mesh.size),
                    "kind": shape.kind})
        with sharding.use_mesh(mesh, _rules(shape.kind, cfg, ruleset)):
            art = cell_artifacts(cfg, shape)
            with op_stats.counting(art.args) as stats:
                out = art.step_fn(*art.args)
        trace_s = time.time() - t0
        out_bytes = op_stats.tree_bytes(out, exclude=art.args)
        static = stats.as_dict()
        rec.update({
            "status": "PASS",
            "trace_s": round(trace_s, 2),
            "memory": {"argument_size_in_bytes": stats.argument_bytes,
                       "output_size_in_bytes": out_bytes,
                       "temp_size_in_bytes": stats.peak_live_bytes - stats.argument_bytes,
                       "peak_live_bytes": stats.peak_live_bytes},
            "cost": {"flops": stats.dot_flops, "bytes accessed": stats.hbm_bytes},
            "static": static,
            "collectives": static["collectives"],
            "collective_ops": _schedule(stats.collective_ops),
        })
    except Exception as e:    # recorded, not raised: the matrix must finish
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        rec["trace_s"] = round(time.time() - t0, 2)
    return _write(out_path, rec) if out_path else rec


# --------------------------------------------------------------------------
# orchestrator
# --------------------------------------------------------------------------

def _cell_path(out_dir: str, mesh: str, arch: str, shape: str,
               quant: Optional[str] = None, ruleset: Optional[str] = None) -> str:
    suffix = (f"__{quant}" if quant else "") + (f"__{ruleset}" if ruleset else "")
    return os.path.join(out_dir, mesh, f"{arch}__{shape}{suffix}.json")


def _write(out_path: str, rec: Dict) -> Dict:
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str,
             force: bool = False, timeout: int = 3600, quant: Optional[str] = None,
             ruleset: Optional[str] = None) -> Dict:
    """One cell in a subprocess (``--single``), its record read back; a
    cached PASS record is reused unless ``force``.  A worker that dies or
    overruns ``timeout`` seconds leaves a FAIL record saying so."""
    out_path = _cell_path(out_dir, mesh_name, arch, shape_name, quant, ruleset)
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            rec = json.load(f)
        if rec.get("status") == "PASS":
            return rec
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    env["PYTHONPATH"] = os.pathsep.join([src, env.get("PYTHONPATH", "")])
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--single", "--arch", arch,
           "--shape", shape_name, "--mesh", mesh_name, "--out", out_dir] \
        + (["--quant", quant] if quant else []) + (["--rules", ruleset] if ruleset else [])
    if os.path.exists(out_path):
        os.unlink(out_path)
    try:
        proc = subprocess.run(cmd, env=env, timeout=timeout, capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        return _write(out_path, {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                                 "status": "FAIL", "error": f"timeout after {timeout}s"})
    if not os.path.exists(out_path):
        return _write(out_path, {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                                 "status": "FAIL",
                                 "error": f"worker died rc={proc.returncode}: "
                                          f"{proc.stderr[-1500:]}"})
    with open(out_path) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--quant", default=None,
                    help="override quant_policy (tnn|tbn|bnn|int8|...), '+'-combinable "
                         "with kv8/kvt2 (int8 / paged ternary KV cache) and noremat")
    ap.add_argument("--rules", default=None, help="override ruleset (train_fsdp|...)")
    ap.add_argument("--single", action="store_true",
                    help="worker mode: trace one cell in this process")
    args = ap.parse_args(argv)

    if args.single:
        rec = run_cell_here(args.arch, args.shape, args.mesh,
                            _cell_path(args.out, args.mesh, args.arch, args.shape,
                                       args.quant, args.rules),
                            quant=args.quant, ruleset=args.rules)
        return 0 if rec["status"] == "PASS" else 1

    from repro_torch.configs import applicable_shapes, list_archs

    archs = [args.arch] if args.arch else list_archs()
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    n_pass = n_fail = 0
    for mesh_name in meshes:
        for arch in archs:
            for shape_name in ([args.shape] if args.shape else applicable_shapes(arch)):
                t0 = time.time()
                rec = run_cell(arch, shape_name, mesh_name, args.out, force=args.force,
                               timeout=args.timeout, quant=args.quant, ruleset=args.rules)
                ok = rec["status"] == "PASS"
                n_pass += ok
                n_fail += not ok
                mem = rec.get("memory", {})
                per_dev = mem.get("peak_live_bytes", 0) / 2**30
                print(f"[{mesh_name:8s}] {arch:25s} {shape_name:12s} {rec['status']:4s} "
                      f"{per_dev:8.2f} GiB/dev peak  "
                      f"flops/dev {rec.get('cost', {}).get('flops', 0):.3g}  "
                      f"coll {rec.get('collectives', {}).get('total', 0):.3g}B  "
                      f"trace {rec.get('trace_s', 0):.1f}s ({time.time() - t0:.0f}s)",
                      flush=True)
                if not ok:
                    print("    " + str(rec.get("error", "?"))[:300], flush=True)
    print(f"\ndry-run: {n_pass} PASS, {n_fail} FAIL", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
