"""One rank of the port's CPU mesh checks (``tests/test_torch_mesh.py``).

``test_torch_mesh.py`` writes the inputs (the reference's packed weights,
activation statistics and LM parameters, as numpy) into a directory,
starts this script as 4 ranks of a gloo world on the CPU
(``launch.mesh.run_ranks``) and asserts on what each rank writes back to
``<dir>/rank<r>.pt``.  The script imports neither JAX nor the JAX
package:

    python tests/torch_mesh_ranks.py <dir>     (RANK, WORLD_SIZE, ... set)
    python tests/torch_mesh_ranks.py --gpu <dir>

On a (2, 2) ("data", "model") mesh each rank runs

* n-, k- and n+k-sharded ``ops.qmm`` (BNN/TNN/TBN, backends "torch" and
  "dense") and cout-sharded ``ops.qconv``, recording the dtype of every
  tensor handed to ``all_reduce`` and the psum counters;
* the single-device ``Engine`` and the mesh ``Engine`` on the same
  packed-``tnn`` smoke tinyllama and prompts (greedy);
* a fake-clock watchdog that hears from every rank but the last;
* ``rebuild_after_loss`` of the last rank with requests in flight;
* an ``autotune="offline"`` mesh engine's sweep of the local problems;
* the agreement helpers: ``Mesh.agree`` on equal and on differing
  values, ``Mesh.from_first``.

``--quarantine`` (2 ranks, a 5 s collective timeout): the single-device
and the (1, 2) mesh ``Engine`` under one fault plan armed on both ranks
(a ``device.loss`` raise and a ``logits.nan`` row, each hit once per tick
on any engine), then ``device.loss`` armed on rank 1 only: the error each
rank's ``run()`` raises and after how long.

``--gpu`` (``tests/test_torch_kernels_gpu.py``, 2 ranks sharing the card
over gloo): a k-sharded TNN ``qmm`` at TinyLlama-1.1B's down projection
(k 5632, n 2048) against the single-device ``qmm`` on the card, and the
launches it made (one int32 TNN GeMM, no fused one), as JSON.
"""

import json
import os
import pickle
import sys
import traceback

import torch
import torch.distributed as dist

from repro_torch import interop, obs
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.common import ShardLayout
from repro_torch.parallel import qmm_mesh, sharding
from repro_torch.runtime.fault_tolerance import WatchdogConfig
from repro_torch.serving import Engine, Request, SamplerConfig, ServeConfig

CASES = {"n": ("model", None), "k": (None, "model"), "nk": ("model", "data")}
QMM_BACKENDS = ("torch", "dense")
CONV_BACKENDS = ("torch", "dense")
BASE = dict(num_slots=2, max_len=16, prefill_bucket=8,
            sampler=SamplerConfig(temperature=0.0), pack_params=True)


def _psum_counts():
    """The psum counters, summed over their labels (by label set for the
    reductions), from the process registry (empty with obs off)."""
    metrics = obs.get_registry().snapshot().get("metrics", {})
    out = {}
    for name in ("repro_mesh_psum_total", "repro_mesh_psum_wire_bytes_total"):
        for s in metrics.get(name, {}).get("series", []):
            key = (name,) + tuple(sorted(s["labels"].items()))
            out[key] = out.get(key, 0) + s["value"]
    return out


def _decode(eng, prompts, max_new=4):
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=max_new))
    return {uid: (r.status, list(r.tokens)) for uid, r in eng.run().items()}


def qmm_checks(inp, mesh, out):
    x = torch.from_numpy(inp["x"])
    reduced = []
    real_all_reduce = dist.all_reduce

    def recording(t, *a, **kw):
        reduced.append(str(t.dtype))
        return real_all_reduce(t, *a, **kw)

    qmm_mesh.reset_collectives()
    before = _psum_counts()
    for (mode, bias), packed in inp["qmm"].items():
        qt = interop.qtensor_from_numpy(packed["payload"], packed["scale"], packed["bias"],
                                        mode, packed["shape"], device="cpu")
        for backend in QMM_BACKENDS:
            out["single"][(mode, bias, backend)] = ops.qmm(
                x, qt, backend=backend, act_stats=packed["stats"]).numpy()
    dist.all_reduce = recording
    try:
        for (mode, bias), packed in inp["qmm"].items():
            qt = interop.qtensor_from_numpy(packed["payload"], packed["scale"], packed["bias"],
                                            mode, packed["shape"], device="cpu")
            for backend in QMM_BACKENDS:
                for label, pspec in CASES.items():
                    with sharding.use_mesh(mesh, sharding.SERVE_RULES_LOWBIT):
                        local = qmm_mesh.take_local(qt.replace(pspec=pspec))
                        plan = qmm_mesh.shard_plan(local)
                        got = ops.qmm(x, local, backend=backend, act_stats=packed["stats"])
                    out["qmm"][(mode, bias, backend, label)] = got.numpy()
                    out["plans"][(mode, label)] = (plan.n_axis, plan.k_axis, plan.acc_dtype)
                    out["local_shapes"][(mode, label)] = tuple(local.payload[
                        next(iter(local.payload))].shape)
    finally:
        dist.all_reduce = real_all_reduce
    after = _psum_counts()
    out["all_reduce_dtypes"] = reduced
    out["collectives"] = qmm_mesh.collectives()
    out["psum_counters"] = {k: after[k] - before.get(k, 0) for k in after}


def qconv_checks(inp, mesh, out):
    x = torch.from_numpy(inp["conv_x"])
    for mode, packed in inp["qconv"].items():
        qt = interop.qtensor_from_numpy(packed["payload"], packed["scale"], None, mode,
                                        packed["shape"], geometry=packed["geometry"],
                                        device="cpu")
        for backend in CONV_BACKENDS:
            with sharding.use_mesh(mesh, sharding.SERVE_RULES_LOWBIT):
                local = qmm_mesh.take_local(qt.replace(pspec=("model", None)))
                got = ops.qconv(x, local, backend=backend, act_stats=packed["stats"])
            out["qconv"][(mode, backend)] = got.numpy()


def engine_checks(inp, mesh, out):
    cfg = get_smoke("tinyllama-1.1b").with_(dtype=torch.float32, quant_policy="tnn",
                                            d_model=128, d_ff=256)
    layout = ShardLayout(tp=1)
    params = interop.lm_params_from_numpy(inp["params"], device="cpu")
    prompts = [torch.tensor(p).numpy() for p in inp["prompts"]]
    out["engine_single"] = _decode(Engine(params, cfg, layout, ServeConfig(**BASE)), prompts)

    eng = Engine(params, cfg, layout, ServeConfig(**BASE, mesh=mesh))
    out["pspecs"] = sorted({str(leaf.pspec) for leaf in _containers(eng.params)})
    out["mesh"] = _decode(eng, prompts)
    out["mesh_again"] = _decode(eng, prompts)

    t = [0.0]
    wd = eng.make_watchdog(WatchdogConfig(dead_after_s=5.0), clock=lambda: t[0])
    silent = mesh.size - 1
    for h in range(silent):
        wd.heartbeat(h, 0.1)
    t[0] = 10.0
    for h in range(silent):
        wd.heartbeat(h, 0.1)
    out["dead"] = wd.check().dead
    eng.close()

    # the offline sweep plans each rank's LOCAL problems (its own cache)
    from repro_torch.tune import cache as tune_cache
    tune_cache.set_cache_path(os.path.join(out["dir"], f"plans_rank{mesh.rank}.json"))
    tuned = Engine(params, cfg, layout, ServeConfig(**BASE, mesh=mesh, autotune="offline"))
    out["tuned_keys"] = sorted(tuned.tune_reports)
    out["tuned"] = _decode(tuned, prompts)
    tuned.close()

    # watchdog -> rebuild with work in flight
    inflight = [torch.tensor(p).numpy() for p in inp["inflight_prompts"]]
    out["single_inflight"] = _decode(Engine(params, cfg, layout, ServeConfig(**BASE)),
                                     inflight)
    eng = Engine(params, cfg, layout, ServeConfig(**BASE, mesh=mesh))
    for uid, p in enumerate(inflight):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=4))
    for _ in range(2):
        eng.step()
    out["busy_before"] = (any(u != -1 for u in eng.slot_uid), len(eng.queue))
    migrated = sorted(r.uid for r in eng._sched.unfinished())
    dead_rank = int(mesh.devices.flat[out["dead"][0]])
    eng2 = eng.rebuild_after_loss([dead_rank])
    out["migrated"] = migrated
    if eng2 is None:
        out["rebuilt"] = None
    else:
        out["rebuilt"] = {"shape": eng2.scfg.mesh.shape,
                          "ranks": eng2.scfg.mesh.devices.reshape(-1).tolist(),
                          "queue": sorted(r.uid for r in eng2.queue),
                          "results": {u: (r.status, list(r.tokens))
                                      for u, r in eng2.run().items()}}
        eng2.close()
    eng.close()


def sync_checks(inp, mesh, out):
    rank = mesh.rank
    mesh.agree([7, 8, 9], "equal values")
    try:
        mesh.agree([rank], "each rank's own rank")
        out["desync_raised"] = False
    except mesh_mod.MeshDesyncError:
        out["desync_raised"] = True
    out["from_first"] = mesh.from_first(100.0 + rank)


def _containers(tree):
    from repro_torch.kernels.qtensor import QTensor

    if isinstance(tree, QTensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [q for v in tree for q in _containers(v)]
    return []


def main(d: str) -> int:
    mesh_mod.init_rank("cpu")
    rank = dist.get_rank()
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {"rank": rank, "dir": d, "qmm": {}, "single": {}, "plans": {}, "local_shapes": {},
           "qconv": {}, "errors": []}
    mesh = mesh_mod.make_serve_mesh(model=2, data=2, device=torch.device("cpu"))
    out["coords"] = mesh.coords
    for check in (qmm_checks, qconv_checks, engine_checks, sync_checks):
        try:
            check(inp, mesh, out)
        except Exception:
            out["errors"].append(f"{check.__name__}: {traceback.format_exc()}")
            break
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    dist.barrier()
    mesh_mod.shutdown()
    return 0


QUARANTINE_TIMEOUT_S = 5.0
QUARANTINE_PLAN = "device.loss@2;logits.nan@4"


def quarantine_main(d: str) -> int:
    import time

    from repro_torch.resilience import faults

    mesh_mod.init_rank("cpu", timeout_s=QUARANTINE_TIMEOUT_S)
    rank = dist.get_rank()
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    cfg = get_smoke("tinyllama-1.1b").with_(dtype=torch.float32, quant_policy="tnn",
                                            d_model=128, d_ff=256)
    layout = ShardLayout(tp=1)
    params = interop.lm_params_from_numpy(inp["params"], device="cpu")
    prompts = [torch.tensor(p).numpy() for p in inp["inflight_prompts"]]
    mesh = mesh_mod.make_serve_mesh(model=2, data=1, device=torch.device("cpu"))
    out = {"rank": rank}
    for name, scfg in (("single", ServeConfig(**BASE)), ("mesh", ServeConfig(**BASE, mesh=mesh))):
        faults.arm(faults.parse_plan(QUARANTINE_PLAN))
        out[name] = _decode(Engine(params, cfg, layout, scfg), prompts)
        out[name + "_report"] = faults.active().report()
        faults.disarm()
    eng = Engine(params, cfg, layout, ServeConfig(**BASE, mesh=mesh))
    if rank == 1:
        faults.arm(faults.parse_plan("device.loss@1"))
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=4))
    t0 = time.monotonic()
    try:
        eng.run()
        out["one_rank"] = (None, "", time.monotonic() - t0)
    except Exception as e:      # the error a one-rank failure ends in
        out["one_rank"] = (type(e).__name__, str(e)[:300], time.monotonic() - t0)
    torch.save(out, os.path.join(d, f"quarantine{rank}.pt"))
    # the group may be broken by the timeout: leave without its teardown
    sys.stdout.flush()
    os._exit(0)


def gpu_main(d: str) -> int:
    from repro_torch.kernels import _build
    from repro_torch.kernels.modes import QuantMode
    from repro_torch.kernels.qtensor import QTensor

    dev = mesh_mod.init_rank("cuda")
    mesh = mesh_mod.make_mesh((1, 2), ("data", "model"), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((5632, 2048), generator=gen, device=dev)
    x = torch.randn((64, 5632), generator=gen, device=dev)
    qt = QTensor.from_dense(w, QuantMode.TNN)
    want = ops.qmm(x, qt)
    with sharding.use_mesh(mesh, sharding.SERVE_RULES_LOWBIT):
        local = qmm_mesh.take_local(qt.replace(pspec=(None, "model")))
        _build.reset_launches()
        got = ops.qmm(x, local)
        torch.cuda.synchronize()
        launches = _build.launches()
    rep = {"rank": dist.get_rank(), "equal": bool(torch.equal(got, want)),
           "local_words": int(local.payload["plus"].shape[1]), "launches": launches,
           "backend": mesh.backend}
    with open(os.path.join(d, f"gpu_rank{rep['rank']}.json"), "w") as f:
        json.dump(rep, f)
    dist.barrier()
    mesh_mod.shutdown()
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "--gpu":
        sys.exit(gpu_main(sys.argv[2]))
    if sys.argv[1] == "--quarantine":
        sys.exit(quarantine_main(sys.argv[2]))
    sys.exit(main(sys.argv[1]))
