"""The port's training mesh on the CPU: 4 ranks of a gloo world, held to
the port's and the JAX package's single-device steps.

One module-scoped fixture writes the inputs (the reference's initial
train states of the smoke ``tinyllama-1.1b`` and ``qwen2-moe-a2.7b``, 2
layers, float32 masters; a batch of 8 x 32 and one of 6 x 32 with a
random mask, both made with numpy; a checkpoint the reference wrote),
starts ``tests/torch_train_mesh_ranks.py`` as 4 ranks
(``launch.mesh.run_ranks``, a hard timeout that kills overrunning ranks)
and, on 2 ranks, ``launch.train`` on the (1, 2) host mesh, and loads what
the ranks wrote.  The cases (``CASES`` there): (2, 2) and (1, 4) under
``TRAIN_RULES`` (tensor and sequence parallel over "model"; the (1, 4)
case's state is built with ``ShardLayout(tp=4)``, which pads the 2 kv
heads to 4), (2, 2) under ``TRAIN_RULES_FSDP``; ``tnn`` and ``bnn``;
float32 and int8 moments; EF on and off; ``microbatch=2``; the bf16 wire
and ``cast_params_bf16=False``; a global batch of 6 on 4 batch shards
(rows 2, 2, 1, 1).  ``launch.train`` runs on 2 ranks beside the same
Trainer built by hand (``--direct``).

Bounds, from the arithmetic of one step (learning rate ``lr``, Adam's
first step ``m / (sqrt(v) + eps) = g / (|g| + eps)``, so each master
moves by ``lr * (sign(g) + wd * p)``):

* the mesh sums each gradient over the batch shards in another order than
  one device sums it over the rows, and the activation statistics of
  every quantized projection are float64 sums of the shards rounded once
  to float32, a few ULPs from one device's float32 sum.  With
  ``cast_params_bf16=False`` every gradient is float32 but the head's: the
  loss multiplies bf16 copies of the head weight (``xent_loss``, as the
  reference), so the head's cotangent rounds to bf16 on each rank before
  the sum (2**-9 relative to each rank's partial sum, so the head's
  gradient is within ``n * 2**-8`` relative for ``n`` rounded partials).
  Statistics a few ULPs apart can move an activation that sits on the
  ternary threshold to the other side; one such flip changes its row's
  output and so every gradient a little: every other gradient is within
  ``F32_GRAD_TOL`` relative (in norm; 4.1e-5 observed on the uneven
  batch, 2.5e-6 on the (2, 2) batch).  Every master is within ``2 * lr``
  elementwise, and at most one element in a thousand of a leaf other
  than the head moves by more than ``1e-3 * lr`` (a gradient within
  rounding of zero whose sign flips);
* on the bf16 wire every rank's cotangent of a 2-D leaf rounds to bf16
  before the bf16 reduce-scatter (the reference's design): gradients
  within a few bf16 ULPs, so ``grad_norm`` within ``BF16_NORM_RTOL``, and
  each master within ``2 * lr`` elementwise (a sign that flips moves it by
  that much at most);
* against the JAX package's single-device step: the port's own bounds
  (``tests/test_torch_train.py``: loss ``rtol=2e-5``) on the loss, and
  each master within ``2 * lr`` elementwise;
* exact (``array_equal``): the first forward's weight planes, each rank's
  rows and its int32 core (given the statistics, and with each side's
  own), EF compression and AdamW on shards of the same whole inputs, an
  int8 moment whose shards cut its blocks, a checkpoint's leaves across
  meshes and packages, and the step after a restore against the same
  step without the disk.
"""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointConfig as JCheckpointConfig
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_smoke as jget_smoke
from repro.data import DataState as JDataState
from repro.data import SyntheticLM as JSyntheticLM
from repro.models.common import ShardLayout as JLayout
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.common import ShardLayout
from repro_torch.optim import adamw, compression
from repro_torch.parallel import sharding
from repro_torch.train import make_train_step
from repro_torch.train.train_step import init_train_state
from repro_torch.tree import flatten_with_paths

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_train_mesh_ranks as R  # noqa: E402

WORLD = 4
RANK_TIMEOUT_S = 240
JL, TL = JLayout(tp=1), ShardLayout(tp=1)
F32_GRAD_TOL = 1e-4
BF16_NORM_RTOL = 1e-3
LAUNCH_LOSS_RTOL = 5e-2
STATES = {("f32", False, 1), ("f32", True, 1), ("int8", True, 1), ("int8", True, 4)}


def _jstate(arch, moments, ef, tp=1):
    jcfg = jget_smoke(arch).with_(dtype=jnp.float32)
    jt = jts.TrainStepConfig(optimizer=jadamw.AdamWConfig(moments_dtype=moments),
                             ef_compression=ef)
    return jts.init_train_state(jax.random.PRNGKey(0), jcfg, JLayout(tp=tp), jt)


def _port_numpy(jstate):
    """The reference's state as the port's numpy tree (port ``Q8`` nodes),
    which the ranks script unpickles without the JAX package."""
    return interop.train_state_to_numpy(
        interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu"))


def _batches():
    nb = JSyntheticLM(vocab_size=512, seq_len=32, global_batch=8, seed=0).batch_at(
        JDataState(0, 0))
    b6 = JSyntheticLM(vocab_size=512, seq_len=32, global_batch=6, seed=1).batch_at(
        JDataState(0, 1))
    rng = np.random.default_rng(3)
    b6["mask"] = (rng.random((6, 32)) < 0.7).astype(np.float32)
    return nb, b6


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("train_mesh"))
    jstates = {(m, ef, tp): _jstate(R.ARCH, m, ef, tp) for m, ef, tp in STATES}
    batch, batch6 = _batches()
    rng = np.random.default_rng(4)
    params = _port_numpy(jstates[("f32", False, 1)])["params"]

    def rand_like(tree):
        return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)

    jck = JCheckpointer(JCheckpointConfig(os.path.join(d, "ckpt_jax"), async_save=False))
    jck.save(0, jstates[("int8", True, 1)])
    jck.wait()
    inp = {"states": {R.state_key(m, ef, tp): _port_numpy(s)
                      for (m, ef, tp), s in jstates.items()},
           "batch": batch, "batch6": batch6, "grads": rand_like(params),
           "ef_err": jax.tree.map(lambda a: 1e-3 * a, rand_like(params)),
           "moe_state": _port_numpy(_jstate("qwen2-moe-a2.7b", "f32", False)),
           "jax_ckpt": os.path.join(d, "ckpt_jax")}
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(os.path.dirname(HERE), "src"),
                                         env.get("PYTHONPATH", "")])
    res = mesh_mod.run_ranks([sys.executable, os.path.join(HERE, "torch_train_mesh_ranks.py"),
                              d], WORLD, timeout_s=RANK_TIMEOUT_S, env=env,
                             log_dir=os.path.join(d, "logs"))
    launch = mesh_mod.run_ranks([sys.executable, os.path.join(HERE, "torch_train_mesh_ranks.py"),
                                 "--launch", d], 2, timeout_s=RANK_TIMEOUT_S, env=env,
                                log_dir=os.path.join(d, "logs_launch"))
    direct = mesh_mod.run_ranks([sys.executable, os.path.join(HERE, "torch_train_mesh_ranks.py"),
                                 "--direct", d], 2, timeout_s=RANK_TIMEOUT_S, env=env,
                                log_dir=os.path.join(d, "logs_direct"))
    assert all(r["returncode"] == 0 for r in res), mesh_mod.rank_logs(res)
    assert all(r["returncode"] == 0 for r in launch), mesh_mod.rank_logs(launch)
    assert all(r["returncode"] == 0 for r in direct), mesh_mod.rank_logs(direct)
    outs = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    for o in outs:
        assert not o["errors"], o["errors"]
    return {"dir": d, "inp": inp, "jstates": jstates, "ranks": outs,
            "launch": torch.load(os.path.join(d, "launch.pt"), weights_only=False),
            "direct": torch.load(os.path.join(d, "direct.pt"), weights_only=False)}


def _single(inp, name):
    """The port's single-device step of case ``name`` on the whole batch:
    (metrics, {path: array}), and the first low-bit projection's record."""
    shape, rules, policy, moments, ef, wire, micro, bkey = R.CASES[name]
    cfg, tcfg = R.step_config(policy, moments, ef, wire, micro)
    layout = R.layout_of(name)
    state = interop.train_state_from_numpy(
        inp["states"][R.state_key(moments, ef, layout.tp)], "cpu")
    box = {}
    real, hooked = R.record_first_qmm(box)
    ops.qmm = hooked
    try:
        state, met = make_train_step(cfg, layout, tcfg)(
            state, R.tensors(inp[bkey], np.arange(inp[bkey]["labels"].shape[0])))
    finally:
        ops.qmm = real
    return ({k: float(v) for k, v in met.items()},
            {k: v.detach().numpy() for k, v in flatten_with_paths(state)}, box)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def single(run):
    return {name: _single(run["inp"], name) for name in R.CASES}


def _jax_step(run, name):
    shape, rules, policy, moments, ef, wire, micro, bkey = R.CASES[name]
    jcfg = jget_smoke(R.ARCH).with_(dtype=jnp.float32, quant_policy=policy)
    jt = jts.TrainStepConfig(
        optimizer=jadamw.AdamWConfig(lr=R.LR, warmup_steps=1, moments_dtype=moments),
        seq_chunk=8, z_loss=1e-4, ef_compression=ef, cast_params_bf16=wire, microbatch=micro)
    tp = R.layout_of(name).tp
    new, met = jts.make_train_step(jcfg, JLayout(tp=tp), jt)(
        run["jstates"][(moments, ef, tp)],
        {k: jnp.asarray(v) for k, v in run["inp"][bkey].items()})
    return ({k: float(v) for k, v in met.items()},
            dict(flatten_with_paths(interop.train_state_from_numpy(
                jax.tree.map(np.asarray, new), device="cpu"))))


def _partials(name):
    """Cotangents rounded to bf16 before the sum: one per batch shard and
    microbatch."""
    shape, rules, *_, micro, _ = R.CASES[name]
    n = shape[0] * (shape[1] if rules == "train_fsdp" else 1)
    return n * micro


@pytest.mark.parametrize("name", list(R.CASES))
def test_mesh_step_matches_single_device(run, single, name):
    """One step on the mesh against the port's single-device step from the
    same state and global batch (module docstring for the bounds)."""
    shape, rules, policy, moments, ef, wire, micro, bkey = R.CASES[name]
    met, want, _ = single[name]
    got, gmet = run["ranks"][0]["states"][name], run["ranks"][0]["metrics"][name]
    for r in run["ranks"]:
        assert r["metrics"][name] == gmet          # every rank reports the same
    assert gmet["tokens"] == met["tokens"]
    if micro == 1:
        assert gmet["tokens"] == float(run["inp"][bkey]["mask"].sum())
    np.testing.assert_allclose(gmet["loss"], met["loss"], rtol=1e-5)
    np.testing.assert_allclose(gmet["nll"], met["nll"], rtol=1e-5)
    np.testing.assert_allclose(gmet["grad_norm"], met["grad_norm"],
                               rtol=BF16_NORM_RTOL if wire else 1e-5)
    assert sorted(got) == sorted(want)
    for k in want:
        if k.startswith("params/"):
            assert np.abs(got[k] - want[k]).max() <= 2 * R.LR + 1e-6, k
        if want[k].dtype.kind != "f" or not k.startswith("opt/m/") or moments != "f32":
            continue
        # m = (1 - b1) g: the gradient's relative error
        if wire:
            tol = _partials(name) * 2.0 ** -8
        else:
            tol = _partials(name) * 2.0 ** -8 if "lm_head" in k else F32_GRAD_TOL
        assert _rel(got[k], want[k]) <= tol, (k, _rel(got[k], want[k]), tol)
    if not wire:
        # masters: all but sign flips of gradients within rounding of zero
        for k in want:
            if k.startswith("params/") and "lm_head" not in k:
                moved = np.abs(got[k] - want[k]) > 1e-3 * R.LR
                assert moved.mean() <= 1e-3, (k, int(moved.sum()))


@pytest.mark.parametrize("name", ["A", "C", "D"])
def test_mesh_step_matches_reference(run, name):
    """The mesh step against the JAX package's single-device step: the
    loss within the port's one-step bound, every master within 2 lr."""
    jmet, want = _jax_step(run, name)
    gmet, got = run["ranks"][0]["metrics"][name], run["ranks"][0]["states"][name]
    np.testing.assert_allclose(gmet["loss"], jmet["loss"], rtol=2e-5)
    np.testing.assert_allclose(gmet["grad_norm"], jmet["grad_norm"], rtol=1e-3)
    for k, w in want.items():
        w = w.numpy()
        if k.startswith("params/"):
            assert np.abs(got[k] - w).max() <= 2 * R.LR + 1e-6, k
        elif w.dtype.kind != "f":
            assert np.array_equal(got[k], w) if k == "opt/step" else True


@pytest.mark.parametrize("name", ["A", "B", "E"])
def test_first_projection_exact(run, single, name):
    """The first forward's first quantized projection (wq): each rank's
    weight planes equal one device's (their n slice at the rank's "model"
    coordinate under ``TRAIN_RULES``' tensor parallelism, whole under
    ``TRAIN_RULES_FSDP``), its rows are one device's rows (the whole
    sequence: the column-parallel input is gathered), its statistics (the
    global batch's) within 4 float32 ULPs of one device's, its int32 core
    equal to the same slice of one device's on those rows given the same
    statistics, and with each side's own."""
    one = single[name][2]
    seq = run["inp"][R.CASES[name][7]]["labels"].shape[1]
    tp = R.CASES[name][0][1] if R.CASES[name][1] == "train" else 1

    def take(t, rows):          # (B * S, n) flattened rows -> the batch rows
        return t.reshape(-1, seq, t.shape[-1])[rows].reshape(-1, t.shape[-1])

    for r in run["ranks"]:
        box, rows = r["first_qmm"][name], r["rows"][name]
        j = r["coords"][name]["model"] if tp > 1 else 0

        def cols(t, dim):       # this rank's n slice of one device's tensor
            n = t.shape[dim] // tp
            return t.narrow(dim, j * n, n)

        for k, v in one["planes"].items():
            assert torch.equal(box["planes"][k], cols(v, 0)), k
        assert torch.equal(box["x"], take(one["x"], rows))
        for k in one["stats"]:
            np.testing.assert_allclose(float(box["stats"][k]), float(one["stats"][k]),
                                       rtol=4 * 2.0 ** -23)
        qt = _qt({k: cols(v, 0) for k, v in one["planes"].items()}, box["x"].shape[-1],
                 R.CASES[name][2])
        xa = ops.quantize_activations(take(one["x"], rows).to(torch.float32), qt.mode,
                                      stats=box["stats"])
        core = ops.packed_matmul({k: v for k, v in xa.items() if k != "scale"}, qt,
                                 backend="torch")
        assert torch.equal(core, box["core"])
        assert torch.equal(box["core"], cols(take(one["core"], rows), 1))


def _qt(planes, k, mode):
    from repro_torch.kernels.modes import QuantMode
    from repro_torch.kernels.qtensor import QTensor

    n = next(iter(planes.values())).shape[0]
    return QTensor(payload=planes, scale=None, mode=QuantMode(mode), shape=(k, n))


def _whole_bytes(run, name):
    """Per leaf: (one device's bytes, its shard count on the case's mesh)."""
    shape, rules, policy, moments, ef, wire, micro, bkey = R.CASES[name]
    cfg, tcfg = R.step_config(policy, moments, ef, wire, micro)
    skeleton = init_train_state(None, cfg, R.layout_of(name), tcfg, device="meta")
    mesh = _FakeMesh(shape)
    sh = dict(flatten_with_paths(sharding.train_state_shardings(
        skeleton, sharding._Active(mesh, sharding.RULESETS[rules]))))
    return {k: (t.numel() * t.element_size(), int(np.prod(sh[k].counts(mesh))))
            for k, t in flatten_with_paths(skeleton)}


class _FakeMesh:
    """Axis sizes only (specs, counts): no ranks."""

    def __init__(self, shape, axes=("data", "model")):
        self.shape, self.axis_names = tuple(shape), tuple(axes)

    def axis_size(self, ax):
        return self.shape[self.axis_names.index(ax)]

    def axis_index(self, ax):
        return 0


@pytest.mark.parametrize("name", list(R.CASES))
def test_local_bytes_are_a_quarter_plus_replicated(run, name):
    """Each rank holds 1/4 of every leaf the mesh splits 4 ways and 1/c of
    a leaf it splits c ways (1 for a replicated one), counted exactly, in
    masters, moments and EF buffers."""
    per = _whole_bytes(run, name)
    want = {}
    for k, (b, c) in per.items():
        group = "opt" if k.startswith("opt/") else k.split("/")[0]
        want[group] = want.get(group, 0) + b // c
    quarter = sum(b for b, c in per.values() if c == 4) // 4
    rest = sum(b // c for b, c in per.values() if c != 4)
    for r in run["ranks"]:
        assert r["bytes"][name] == want
        assert sum(r["bytes"][name].values()) == quarter + rest
    print(name, "single", sum(b for b, _ in per.values()), "per rank", quarter + rest,
          "replicated or split < 4 ways", rest)


@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_ef_compression_on_shards_exact(run, moments):
    """EF compression of shards (global absmax per leaf) == one device's,
    elementwise, given the same whole gradients and error buffers."""
    grads = interop.train_state_from_numpy(run["inp"]["grads"], "cpu")
    err = interop.train_state_from_numpy(run["inp"]["ef_err"], "cpu")
    deq, new_err = compression.ef_compress_update(grads, err)
    got = run["ranks"][0]["ef"][moments]
    for k, v in flatten_with_paths(deq):
        assert np.array_equal(got["deq"][k], v.numpy()), k
    for k, v in flatten_with_paths(new_err):
        assert np.array_equal(got["err"][k], v.numpy()), k


@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_adamw_on_shards_exact(run, moments):
    """AdamW (clip off) on shards == one device's update elementwise, int8
    moments included (their blocks cut by shards: ``Q8Layout``), given the
    same whole state and gradients; the global norm within float32
    rounding."""
    cfg, tcfg = R.step_config("tnn", moments, True, True, 1, clip=0.0)
    state = interop.train_state_from_numpy(run["inp"]["states"][R.state_key(moments, True)],
                                           "cpu")
    grads = interop.train_state_from_numpy(run["inp"]["grads"], "cpu")
    err = interop.train_state_from_numpy(run["inp"]["ef_err"], "cpu")
    deq, _ = compression.ef_compress_update(grads, err)
    p, o, met = adamw.adamw_update(deq, state["opt"], state["params"], tcfg.optimizer)
    got = run["ranks"][0]["adamw"][moments]
    for k, v in flatten_with_paths({"params": p, "opt": o}):
        assert np.array_equal(got["state"][k], v.numpy()), k
    np.testing.assert_allclose(got["grad_norm"], float(met["grad_norm"]), rtol=1e-6)


def test_q8_block_cut_by_shard(run):
    """A (64, 768) int8 moment on (2, 2): shards of 384 columns cut the
    middle 256-block; q, scale and the dequantized shard equal one
    device's."""
    for r in run["ranks"]:
        c = r["q8_cut"]
        assert c["cuts"] and c["spec"] == ("data", "model") and c["scale_spec"] == ("data", None)
        assert c["q"] and c["scale"] and c["deq"]


def _npz(d, step):
    with np.load(os.path.join(d, f"step_{step:06d}", "host_0.npz")) as z:
        return {k: z[k] for k in z.files}


def test_checkpoint_saved_on_2x2_restores_on_4x1(run):
    """A (2, 2) checkpoint holds whole leaves (the state case "B" stepped
    to), restores onto (4, 1) equal to them, and the step after the
    restore equals the same step on the state re-sharded in memory."""
    ck = run["ranks"][0]["ckpt"]
    assert ck["extra"] == {"data_state": {"step": 1, "seed": 0}}
    saved = _npz(os.path.join(run["dir"], "ckpt_mesh"), 1)
    want = run["ranks"][0]["states"]["B"]
    assert sorted(saved) == sorted(want)
    for k in want:
        assert np.array_equal(saved[k], want[k]), k
    for r in run["ranks"]:
        assert r["ckpt"]["restored_equal"] and r["ckpt"]["resume_equal"]
        assert r["ckpt"]["resume_loss"][0] == r["ckpt"]["resume_loss"][1]
    assert sorted(os.listdir(os.path.join(run["dir"], "ckpt_mesh"))) == ["step_000001"]


def test_reference_restores_mesh_checkpoint(run):
    """The JAX package's ``Checkpointer.restore`` reads the mesh's
    checkpoint, leaf for leaf."""
    jstate = run["jstates"][("int8", True, 1)]
    got, extra = JCheckpointer(JCheckpointConfig(os.path.join(run["dir"], "ckpt_mesh"))) \
        .restore(1, jstate)
    assert extra["data_state"]["step"] == 1
    want = _npz(os.path.join(run["dir"], "ckpt_mesh"), 1)
    flat = dict(flatten_with_paths(interop.train_state_from_numpy(
        jax.tree.map(np.asarray, got), device="cpu")))
    for k in want:
        assert np.array_equal(flat[k].numpy(), want[k]), k


def test_mesh_restores_reference_checkpoint(run):
    """The port's mesh restore reads a checkpoint the JAX package wrote
    onto (2, 2): every gathered leaf equals the reference's."""
    got = run["ranks"][0]["ckpt"]["from_reference"]
    want = dict(flatten_with_paths(interop.train_state_from_numpy(
        jax.tree.map(np.asarray, run["jstates"][("int8", True, 1)]), device="cpu")))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v.numpy()), k


def test_moe_aux_loss_on_split_batch(run):
    """qwen2-moe smoke under ``TRAIN_RULES_FSDP`` on (2, 2), each rank 2
    of the 8 rows: the aux loss (global token and probability fractions),
    the loss and the updated router equal one device's within float32
    summation order."""
    cfg, tcfg = R.step_config("f32", "f32", False, False, 1, arch="qwen2-moe-a2.7b")
    state = interop.train_state_from_numpy(run["inp"]["moe_state"], "cpu")
    state, met = make_train_step(cfg, TL, tcfg)(
        state, R.tensors(run["inp"]["batch"], np.arange(8)))
    got = run["ranks"][0]["moe"]
    assert met["aux"] > 0
    np.testing.assert_allclose(got["metrics"]["aux"], float(met["aux"]), rtol=1e-5)
    np.testing.assert_allclose(got["metrics"]["loss"], float(met["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], float(met["grad_norm"]), rtol=1e-4)
    want = dict(flatten_with_paths(state))
    for k in want:
        if k.startswith("opt/m/") and "router" in k:
            assert _rel(got["state"][k], want[k].numpy()) <= 1e-4, k


def test_watchdog_hears_every_rank(run):
    """Every rank's watchdog flags the rank that reports slow steps after
    ``grace_steps`` (2), every rank stops at the same step after saving
    the mesh checkpoint, and the restart is planned for the 3 ranks left
    (fewer than one model-parallel group of the reference's plan: None).
    Rank 0 alone logs."""
    for r in run["ranks"]:
        wd = r["watchdog"]
        assert wd["final_step"] == 2 and wd["plan"] is None
        assert bool(wd["logs"]) == (r["rank"] == 0), wd["logs"]
    assert any("stragglers=[3]" in m for m in run["ranks"][0]["watchdog"]["logs"])
    step = os.path.join(run["dir"], "ckpt_watchdog", "step_000002")
    assert sorted(os.listdir(step)) == ["MANIFEST.json", "host_0.npz"]


def test_uneven_rows_global_mean(run, single):
    """A global batch of 6 on 4 batch shards: rows 2, 2, 1, 1, and the
    loss is the global batch's mean over its masked tokens."""
    rows = [r["rows"]["E"] for r in run["ranks"]]
    coords = [r for r in run["ranks"]]
    assert sorted(map(len, rows)) == [1, 1, 2, 2]
    assert sorted(i for rr in rows for i in rr) == list(range(6))
    assert len(coords) == 4
    np.testing.assert_allclose(run["ranks"][0]["metrics"]["E"]["loss"],
                               single["E"][0]["loss"], rtol=1e-5)


def test_launch_train_on_two_ranks(run):
    """``launch.train`` on 2 ranks (the (1, 2) host mesh under
    ``TRAIN_RULES``: heads, FFN, vocab and the sequence split over
    "model", the batch whole on each rank) against the single-device run,
    all 6 steps.

    The first step's forward is one device's (integer cores equal,
    statistics within float32 rounding): its loss within ``rtol=1e-5``.
    Its gradients are one device's within bf16 rounding: the ranks' partial
    cotangents of a column-parallel input are summed in float32 and rounded
    once, where one device rounds each projection's cotangent and then
    their sum, so ``grad_norm`` within ``BF16_NORM_RTOL``.  Adam's first
    update is ``lr * sign(g)``, so the elements whose gradient lies within
    that rounding of zero (about 0.07% of them at this size) take the
    opposite step, and the QAT loss of this small model moves by about 1%
    when that many masters move by ``2 * lr``.  Its later losses are held
    to one device's within ``LAUNCH_LOSS_RTOL``: twice the largest
    deviation of one device's own 6 losses when the signs of a random
    0.07% of its first gradients flip (2.5e-2 over 8 draws).  That bound
    sees the step's wiring, not a backward fault (one that drops the
    partial cotangents' sum stays inside it while its ``grad_norm`` is 2.7
    times one device's); the first ``grad_norm`` here and
    ``tests/test_torch_train_tp.py`` hold the backward.  The 6 losses also
    equal, within ``rtol=1e-5``, those of the same Trainer built by hand on
    that mesh (``--direct``)."""
    from repro_torch.launch import train as launch_train

    norms = []
    undo = R.record_grad_norms(norms)
    try:
        res = launch_train.main(R.LAUNCH_ARGS)
    finally:
        undo()
    got = run["launch"]
    assert got["final_step"] == 6
    np.testing.assert_allclose(got["losses"][0], res.losses[0], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"][0], norms[0], rtol=BF16_NORM_RTOL)
    np.testing.assert_allclose(got["losses"], res.losses, rtol=LAUNCH_LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], run["direct"]["losses"], rtol=1e-5)


def test_launch_train_mesh_checkpoint_is_whole(run):
    """The Trainer on 2 ranks saves the reference's format: one
    ``host_0.npz`` of whole leaves, which the port's one-device restore
    reads into a one-device state and the JAX package's restore reads
    too."""
    from repro_torch.checkpoint import Checkpointer, CheckpointConfig
    from repro_torch.configs import get_smoke
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainStepConfig

    d = os.path.join(run["dir"], "ckpt_launch")
    ck = Checkpointer(CheckpointConfig(d))
    step = ck.latest_step()
    assert step == 6
    assert sorted(os.listdir(os.path.join(d, f"step_{step:06d}"))) == [
        "MANIFEST.json", "host_0.npz"]
    cfg = get_smoke(R.ARCH, quant_policy="tnn")
    tcfg = TrainStepConfig(optimizer=AdamWConfig())
    target = init_train_state(None, cfg, ShardLayout(tp=2), tcfg, device="meta")
    got, extra = ck.restore(step, target, device="cpu")
    assert extra["data_state"]["step"] == 6
    want = _npz(d, step)
    for k, v in flatten_with_paths(got):
        assert np.array_equal(v.numpy(), want[k]), k
    jcfg = jget_smoke(R.ARCH).with_(quant_policy="tnn")
    jt = jts.TrainStepConfig(optimizer=jadamw.AdamWConfig())
    jtarget = jts.init_train_state(jax.random.PRNGKey(1), jcfg, JLayout(tp=2), jt)
    jgot, _ = JCheckpointer(JCheckpointConfig(d)).restore(step, jtarget)
    flat = dict(flatten_with_paths(interop.train_state_from_numpy(
        jax.tree.map(np.asarray, jgot), device="cpu")))
    for k in want:
        assert np.array_equal(flat[k].numpy(), want[k]), k


def test_launch_train_production_needs_256_ranks():
    from repro_torch.launch import train as launch_train

    with pytest.raises(RuntimeError, match="need 256 devices for mesh"):
        launch_train.main(["--smoke", "--device", "cpu", "--production"])


# ------------------------------------------------- rules, rows (no ranks)

@pytest.mark.parametrize("rules,shape,axes,want", [
    ("train", (2, 2), ("data", "model"), ("data",)),
    ("train", (1, 4), ("data", "model"), ("data",)),
    ("train_fsdp", (2, 2), ("data", "model"), ("data", "model")),
    ("train", (2, 2, 2), ("pod", "data", "model"), ("pod", "data")),
    ("train_hybrid", (2, 4), ("data", "model"), ("data",)),
])
def test_batch_axes_from_rules(rules, shape, axes, want):
    """The batch axes come from the rules' "batch" entry: under
    ``TRAIN_RULES`` "model" never splits the batch."""
    ctx = sharding._Active(_FakeMesh(shape, axes), sharding.RULESETS[rules])
    assert sharding.batch_axes(ctx) == want


@pytest.mark.parametrize("global_batch,shards,micro,want", [
    (8, 4, 1, [[0, 1], [2, 3], [4, 5], [6, 7]]),
    (6, 4, 1, [[0, 1], [2, 3], [4], [5]]),
    (8, 2, 2, [[0, 1, 4, 5], [2, 3, 6, 7]]),
    (8, 4, 2, [[0, 4], [1, 5], [2, 6], [3, 7]]),
])
def test_mesh_rows(global_batch, shards, micro, want):
    """Rows by batch coordinate; with microbatches each rank's i-th
    microbatch is its share of the global i-th one."""
    from repro_torch.data.pipeline import mesh_rows

    assert [mesh_rows(global_batch, c, shards, micro).tolist()
            for c in range(shards)] == want


def test_mesh_rows_refuses_unequal_microbatch_shares():
    from repro_torch.data.pipeline import mesh_rows

    with pytest.raises(ValueError, match="equal shares"):
        mesh_rows(6, 0, 4, 2)


class _OneShard:
    """A split batch of one shard: its reductions are the identity."""
    axes = ("data",)

    def reduce(self, t, op="sum"):
        return t


@pytest.mark.parametrize("mode", ["tnn", "tbn", "bnn", "int8", "int4"])
def test_split_batch_stats_of_one_shard(mode):
    """The split batch's activation statistics on one shard are the
    one-device statistics: u8/u4's range exactly, the ternary threshold and
    scales within 2 float32 ULPs (float64 sums rounded once, against
    float32 sums), and the quantized activations equal."""
    from repro_torch.kernels.modes import QuantMode

    g = torch.Generator().manual_seed(9)
    x = torch.randn((64, 96), generator=g)
    mode = QuantMode(mode)
    got = ops.split_batch_stats(x, mode, _OneShard())
    want = ops.quantize_activations(x, mode)
    xa = ops.quantize_activations(x, mode, stats=got)
    if mode in (QuantMode.INT8, QuantMode.INT4):
        assert torch.equal(got["scale"], want["scale"]) and torch.equal(got["zero"], want["zero"])
    else:
        np.testing.assert_allclose(float(got["scale"]), float(want["scale"]), rtol=2 * 2.0 ** -23)
    for k in want:
        if k != "scale":
            assert torch.equal(xa[k], want[k]), k


def test_split_batch_is_seen_by_other_threads():
    """Autograd runs a CUDA backward, remat's recompute with it, on its own
    thread: the split batch declared by the step is visible there, so the
    recompute quantizes with the global batch's statistics as the forward
    did."""
    import threading

    seen = []
    mesh = _FakeMesh((2, 2))
    with sharding.split_batch(mesh, ("data",)):
        t = threading.Thread(target=lambda: seen.append(sharding.batch_split()))
        t.start()
        t.join()
    assert seen[0] is not None and seen[0].axes == ("data",)
    assert sharding.batch_split() is None


def test_split_batch_from_another_thread_raises():
    """The split is the process's: a second one declared from another
    thread while a step's is active raises instead of mixing two steps'
    collectives; off the mesh (``mesh=None``) it is a no-op."""
    import threading

    errors = []
    mesh = _FakeMesh((2, 2))

    def other():
        try:
            with sharding.split_batch(mesh, ("data",)):
                pass
        except RuntimeError as e:
            errors.append(e)

    with sharding.split_batch(mesh, ("data",)):
        t = threading.Thread(target=other)
        t.start()
        t.join()
        with sharding.split_batch(None, ()):
            assert sharding.batch_split().axes == ("data",)
    assert len(errors) == 1
    assert sharding.batch_split() is None


def test_moments_shard_as_their_parameter():
    """Every moment and EF buffer follows its parameter's spec (a norm
    scale's moment too), an int8 moment's scale the parameter's rule on
    its own shape."""
    cfg, tcfg = R.step_config("tnn", "int8", True, True, 1)
    skeleton = init_train_state(None, cfg, TL, tcfg, device="meta")
    ctx = sharding._Active(_FakeMesh((2, 2)), sharding.TRAIN_RULES)
    sh = sharding.train_state_shardings(skeleton, ctx)
    flat = dict(flatten_with_paths(sh))
    for path, p in flatten_with_paths(sh["params"]):
        for opt in ("opt/m/", "opt/v/"):
            assert flat[f"{opt}{path}/q"].spec == p.spec
        assert flat[f"ef/{path}"].spec == p.spec
    assert flat["params/blocks/0/pre_ffn_norm/scale"].spec == (None, "model")
    assert flat["opt/m/blocks/0/mixer/wk/w/scale"].spec == (None, "data", None)
    assert flat["opt/step"].spec == ()
