"""Tensor-parallel training of MoE experts and Mamba2 SSM heads on the
CPU: 4 ranks of a gloo world on the (2, 2) ("data", "model") mesh, held
to one device.

One module fixture writes the inputs (operands, statistics and layer
parameters made with numpy; the JAX package's initial train states of
three small configs, float32 activations, remat: Qwen2-MoE-A2.7B's smoke
with d_ff 128 and a shared expert of 256 (8 experts, top 4), Mamba2's
smoke (d_inner 128, 8 heads of 16, 1 group) and Jamba's (A + M + E: 8
layers, 8 SSM heads in 2 groups, 4 experts top 2, d_ff 128); a batch of
8 x 64) so that every rank's ffn and d_inner slices are whole 32-bit
words, starts ``tests/torch_train_tp_moe_ssm_ranks.py`` as 4 ranks
(``launch.mesh.run_ranks``, a hard timeout) and loads what they wrote.

Bounds:

* (a) exact (``torch.equal``), with the statistics passed in: an
  expert's column-parallel output is one device's n slice, the
  row-parallel experts' outputs (their int32 partial counts summed over
  "model" in one all-reduce, then eq. (2)) are one device's, and the
  Mamba2 ``in_proj`` on a rank's columns is one device's at those
  columns;
* (b) the MoE and SSM layers (f32) on a rank's rows and sequence shard
  against one device's on the whole batch: the outputs and the input's
  gradient within ``LAYER_RTOL`` (relative in norm: the row-parallel
  float32 partial sums and the norm's sum of squares add in another
  order), the aux loss within ``LOSS_RTOL``, the router's gradient summed
  over the 4 ranks, the experts' and heads' chunks' gradients summed over
  "data" and the whole leaves' summed over all 4 ranks within
  ``LAYER_RTOL``;
* (c) one step against the JAX package's single-device step on the same
  weights and global batch, ``tests/test_torch_train_tp.py``'s bounds:
  ``f32`` (float32 projections and wire) the loss within ``LOSS_RTOL``,
  the grad norm within ``F32_NORM_RTOL``, every first moment within
  ``F32_GRAD_TOL`` relative in norm but the head's (Mamba2's tied
  embedding; its cotangent rounds to bf16 on each of the 2 batch shards:
  ``2 * 2**-8``), every master
  within ``2 lr`` and at most one element in a thousand of a leaf moved
  by more than ``1e-3 lr``; ``tnn`` (the bf16 wire, int8 moments, EF) the
  loss within ``2e-5``, the grad norm within ``1e-3``, every master
  within ``2 lr``.  Jamba is held to the JAX package more loosely, by
  how far the port's own single-device step sits from it (measured):
  its first moments up to 1.7e-4 (``A_log``, ``conv_w``: 8 layers of the
  float32 SSD scan and 4 MoE layers add in another order) against
  ``REF_GRAD_TOL``, and up to 0.39% of a leaf's masters moved by more
  than ``1e-3 lr`` (3 of ``conv_w``'s 768; 2.0e-3 of an expert's up
  projection: its first-step gradients crowd zero), so no count of moved
  masters.  The mesh's own part is held to the port's single-device step
  for every config: the f32 bounds above with every first moment within
  ``F32_GRAD_TOL`` (measured: 3.3e-5 at most), and for Jamba at most
  ``JAMBA_MOVED`` of a leaf, or one element, moved (measured: 1.3e-3,
  one of ``conv_w``'s 768; one device with its batch rows reversed moves
  at most 2 elements of a leaf).  The step's collectives equal
  ``roofline.analysis.train_mesh_collectives``.  Jamba's ``tnn`` step is
  held to the port's single-device step only, to the ``tnn`` bounds;
* (d) a placeholder (2, 2) rank's float products are the share of one
  device's that ``roofline.analysis.train_step_flops`` predicts from the
  shapes (a quarter, but for the B and C columns and C B^T each "model"
  rank repeats when the groups do not split), within 1%; its collectives
  equal the prediction under the three training rulesets;
* (e) two faults are caught: Mamba2's gated norm with its sum of squares
  not summed over "model" moves the loss far outside ``LOSS_RTOL``;
  Qwen2-MoE's router summing its gradient over "model" too under
  TRAIN_RULES_HYBRID (where each "model" rank computes it whole) counts
  it twice: its first moment moves far outside ``F32_GRAD_TOL``.
"""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models.common import ShardLayout as JLayout
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.core import quantize
from repro_torch.data import DataState, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.kernels.modes import QuantMode
from repro_torch.kernels.qtensor import QTensor
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.parallel import sharding
from repro_torch.tree import flatten_with_paths, tree_map

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_train_tp_moe_ssm_ranks as R  # noqa: E402

WORLD = 4
RANK_TIMEOUT_S = 300
LOSS_RTOL = 1e-5
LAYER_RTOL = 1e-5
F32_NORM_RTOL = 1e-4
F32_GRAD_TOL = 1e-4
REF_GRAD_TOL = 5e-4
MOVED = 1e-3
JAMBA_MOVED = 2e-3
RUNS = [(a, c) for a in R.ARCHS for c in R.CASES]
# the runs held to the JAX package's single-device step, and to the
# port's: Jamba's tnn step only to the port's (the reference's compile
# of it would take a minute of this file's time)
JAX_RUNS = [r for r in RUNS if r != ("jamba-1.5-large-398b", "train_tnn")]
PORT_RUNS = [r for r in RUNS if R.CASES[r[1]][1] == "f32" or r not in JAX_RUNS]


def _jcfg(arch, policy):
    return jget_smoke(arch).with_(dtype=jnp.float32, remat=True, quant_policy=policy,
                                  **R.ARCHS[arch])


def _jtcfg(moments, ef, wire):
    return jts.TrainStepConfig(
        optimizer=jadamw.AdamWConfig(lr=R.LR, warmup_steps=1, moments_dtype=moments),
        seq_chunk=32, z_loss=1e-4, ef_compression=ef, cast_params_bf16=wire)


def _stats(x, w, mode):
    """One device's activation statistics of ``x`` (per tensor) and
    weight statistics of ``w`` (per output channel), as numpy."""
    x, w = torch.from_numpy(x).reshape(-1, x.shape[-1]), torch.from_numpy(w)
    if mode == "bnn":
        act = {"scale": quantize.mean_abs(x)}
    else:
        _, scale = quantize.ternarize(x)
        act = {"thr": quantize.ternary_threshold(x), "scale": scale}
    qt = QTensor.from_dense(w, QuantMode(mode))
    wst = {"scale": qt.scale}
    if mode == "tnn":
        wst["thr"] = 0.7 * quantize.mean_abs(w, dim=0)
    return ({k: np.float32(v) for k, v in act.items()},
            {k: v.numpy() for k, v in wst.items()})


def _layer_inputs(rng):
    """(b)'s layers: parameters drawn by the port's init (one device's
    whole leaves), the dim each leaf's "model" chunk is cut along, an
    input and a cotangent."""
    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    out = {}
    for fn, arch in (("moe", "qwen2-moe-a2.7b"), ("ssm", "mamba2-1.3b")):
        cfg = R.config(arch)[0]
        gen = torch.Generator().manual_seed(5)
        if fn == "moe":
            p = moe_mod.init_moe(gen, cfg, device="cpu")
            dims = {"gate/w": 2, "up/w": 2, "down/w": 1, "shared/gate/w": 1,
                    "shared/up/w": 1, "shared/down/w": 0}
        else:
            p = ssm_mod.init_ssm(gen, cfg, device="cpu")
            p["norm"] = p["norm"] + torch.from_numpy(normal(*p["norm"].shape)) * 0.1
            dims = {"A_log": 0, "D": 0, "dt_bias": 0, "norm": 0, "out_proj/w": 0}
        out[fn] = {"params": tree_map(lambda t: t.numpy(), p), "dims": dims,
                   "x": normal(R.BATCH, R.SEQ, cfg.d_model),
                   "cot": normal(R.BATCH, R.SEQ, cfg.d_model)}
    return out


def _inputs(rng):
    f32 = np.float32

    def normal(*shape):
        return rng.standard_normal(shape).astype(f32)

    proj, ssm_proj = {}, {}
    cfg = R.config("mamba2-1.3b")[0]
    n_in = 2 * cfg.ssm_d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state + cfg.ssm_nheads
    for mode in R.MODES:
        x, wc = normal(R.EXPERTS, R.ROWS, R.D_IN), normal(R.EXPERTS, R.D_IN, R.D_FF) * f32(0.1)
        h, wr = normal(R.EXPERTS, R.ROWS, R.D_FF), normal(R.EXPERTS, R.D_FF, R.D_IN) * f32(0.1)
        col = [_stats(x[e], wc[e], mode) for e in range(R.EXPERTS)]
        row = [_stats(h[e], wr[e], mode) for e in range(R.EXPERTS)]
        proj[mode] = {"x": x, "w_col": wc, "h": h, "w_row": wr,
                      "ast_col": [a for a, _ in col], "wst_col": [w for _, w in col],
                      "ast_row": [a for a, _ in row], "wst_row": [w for _, w in row]}
        xs, ws = normal(R.ROWS, cfg.d_model), normal(cfg.d_model, n_in) * f32(0.1)
        ast, wst = _stats(xs, ws, mode)
        ssm_proj[mode] = {"x": xs, "w": ws, "ast": ast, "wst": wst}
    return proj, ssm_proj, _layer_inputs(rng)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("train_tp_moe_ssm"))
    rng = np.random.default_rng(13)
    proj, ssm_proj, layers = _inputs(rng)
    jstates, states = {}, {}
    for arch in R.ARCHS:
        for rules, policy, moments, ef, wire in R.CASES.values():
            key = R.state_key(arch, moments, ef)
            if key not in jstates:
                jstates[key] = jts.init_train_state(jax.random.PRNGKey(0), _jcfg(arch, "f32"),
                                                    JLayout(tp=1), _jtcfg(moments, ef, wire))
                states[key] = interop.train_state_to_numpy(interop.train_state_from_numpy(
                    jax.tree.map(np.asarray, jstates[key]), device="cpu"))
    batch = SyntheticLM(vocab_size=512, seq_len=R.SEQ, global_batch=R.BATCH,
                        seed=0).batch_at(DataState(0, 0))
    inp = {"proj": proj, "ssm_proj": ssm_proj, "layers": layers, "states": states,
           "batch": batch}
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(os.path.dirname(HERE), "src"),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    res = mesh_mod.run_ranks([sys.executable, os.path.join(HERE,
                                                           "torch_train_tp_moe_ssm_ranks.py"), d],
                             WORLD, timeout_s=RANK_TIMEOUT_S, env=env,
                             log_dir=os.path.join(d, "logs"))
    assert all(r["returncode"] == 0 for r in res), mesh_mod.rank_logs(res)
    outs = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    for o in outs:
        assert not o["errors"], o["errors"]
    return {"inp": inp, "jstates": jstates, "ranks": outs}


def _seq(t, j, tp=2, dim=1):
    n = t.shape[dim] // tp
    return t.narrow(dim, j * n, n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _st(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("mode", R.MODES)
def test_expert_and_in_proj_forward_exact(run, mode):
    """Column-parallel experts: each rank's output is one device's n slice;
    row-parallel experts, reduced together: one device's outputs; in_proj
    on a rank's heads' columns: one device's at those columns;
    ``torch.equal``, the same statistics given to both."""
    a, s = run["inp"]["proj"][mode], run["inp"]["ssm_proj"][mode]

    def one(x, w, ast, wst):
        qt = QTensor.from_dense(torch.from_numpy(w), QuantMode(mode), stats=_st(wst))
        return ops.qmm(torch.from_numpy(x), qt, backend="torch", act_stats=_st(ast))

    col = [one(a["x"][e], a["w_col"][e], a["ast_col"][e], a["wst_col"][e])
           for e in range(R.EXPERTS)]
    row = [one(a["h"][e], a["w_row"][e], a["ast_row"][e], a["wst_row"][e])
           for e in range(R.EXPERTS)]
    in_proj = one(s["x"], s["w"], s["ast"], s["wst"])
    for r in run["ranks"]:
        j, got = r["a"]["model"], r["a"]["out"][mode]
        for e in range(R.EXPERTS):
            assert torch.equal(got["col"][e], _seq(col[e], j, dim=1)), e
            assert torch.equal(got["row"][e], row[e]), e
        assert torch.equal(got["in_proj"], in_proj[:, got["cols"]])


def test_in_proj_columns_are_the_ranks_heads():
    """A rank's in_proj columns are its heads' z, x and dt and the B and C
    of its heads' groups: each group's on its own rank when the groups
    split (Jamba: 8 heads, 2 groups), the one group on both when not
    (Mamba2)."""
    for arch, groups in (("mamba2-1.3b", [[0], [0]]), ("jamba-1.5-large-398b", [[0], [1]])):
        cfg = R.config(arch)[0]
        din, g, n, h, p = (cfg.ssm_d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads,
                           cfg.ssm_headdim)
        seen = []
        for j in range(2):
            dims, cols, chans = ssm_mod._tp_dims(cfg, 2, j, torch.device("cpu"))
            heads = range(j * h // 2, (j + 1) * h // 2)
            want = [c for hh in heads for c in range(hh * p, (hh + 1) * p)]
            want += [din + c for c in want]
            for part in (0, 1):
                want += [2 * din + part * g * n + gg * n + i for gg in groups[j] for i in range(n)]
            want += [2 * din + 2 * g * n + hh for hh in heads]
            assert cols.tolist() == want, (arch, j)
            assert chans.tolist() == [c - din for c in want if din <= c < 2 * din + 2 * g * n]
            assert dims == (din // 2, len(groups[j]), n, p, h // 2,
                            din // 2 + 2 * len(groups[j]) * n)
            seen += [c for c in want if c < din]
        assert sorted(seen) == list(range(din)), arch


# ------------------------------------------------------------------ (b)

def _one_device_layer(inp, fn):
    cfg = R.config("qwen2-moe-a2.7b" if fn == "moe" else "mamba2-1.3b")[0]
    lay = inp["layers"][fn]
    x = torch.from_numpy(lay["x"]).requires_grad_(True)

    params = tree_map(lambda t: torch.from_numpy(t).requires_grad_(True), lay["params"])
    leaves = flatten_with_paths(params)
    if fn == "moe":
        y, aux = moe_mod.moe_ffn(params, x, cfg, cfg.policy)
        total = (y * torch.from_numpy(lay["cot"])).sum() + aux
    else:
        y, aux = ssm_mod.ssm_forward(params, x, cfg, cfg.policy), torch.zeros(())
        total = (y * torch.from_numpy(lay["cot"])).sum()
    grads = torch.autograd.grad(total, [x] + [t for _, t in leaves])
    return y.detach(), aux.detach(), grads[0], {p: g for (p, _), g in zip(leaves, grads[1:])}


@pytest.mark.parametrize("fn", ["moe", "ssm"])
def test_layer_matches_one_device(run, fn):
    """The tensor-parallel MoE / SSM layer (f32, TRAIN_RULES' split) on a
    rank's rows and sequence shard against one device's on the whole
    batch: output and input gradient within LAYER_RTOL, the aux loss
    within LOSS_RTOL, every leaf's gradient (chunks summed over "data",
    whole leaves over all ranks: the router's sums each rank's sequence
    shard) within LAYER_RTOL."""
    inp = run["inp"]
    y, aux, gx, grads = _one_device_layer(inp, fn)
    aux = float(aux)
    dims = inp["layers"][fn]["dims"]
    summed = {}
    for r in run["ranks"]:
        rows, j, got = r["b"]["rows"], r["b"]["model"], r["b"]["out"][fn]
        assert _rel(got["y"], _seq(y[rows], j)) <= LAYER_RTOL
        assert _rel(got["gx"], _seq(gx[rows], j)) <= LAYER_RTOL
        np.testing.assert_allclose(got["aux"], aux, rtol=LOSS_RTOL)
        for p, g in got["grads"].items():
            key = (p, j) if p in dims else (p, None)
            summed[key] = summed.get(key, 0) + g.to(torch.float64)
    for (p, j), g in summed.items():
        want = grads[p] if j is None else _seq(grads[p], j, dim=dims[p])
        assert _rel(g, want) <= LAYER_RTOL, (fn, p, j, _rel(g, want))
    assert {p for p, _ in summed} == set(grads)
    if fn == "moe":
        assert abs(aux) > 0 and "router" in grads


# ------------------------------------------------------------------ (c)

@pytest.fixture(scope="module")
def jax_steps(run):
    """The JAX package's single-device step of every run of JAX_RUNS (one
    per policy: the rules do not reach one device)."""
    done, out = {}, {}
    for arch, name in JAX_RUNS:
        rules, policy, moments, ef, wire = R.CASES[name]
        key = (arch, policy, moments, ef, wire)
        if key not in done:
            new, met = jts.make_train_step(_jcfg(arch, policy), JLayout(tp=1),
                                           _jtcfg(moments, ef, wire))(
                run["jstates"][R.state_key(arch, moments, ef)],
                {k: jnp.asarray(v) for k, v in run["inp"]["batch"].items()})
            done[key] = ({k: float(v) for k, v in met.items()},
                         {k: v.numpy() for k, v in
                          flatten_with_paths(interop.train_state_from_numpy(
                              jax.tree.map(np.asarray, new), device="cpu"))})
        out[f"{arch}/{name}"] = done[key]
    return out


@pytest.fixture(scope="module")
def port_steps(run):
    """The port's single-device step of every run of PORT_RUNS on the same
    state and global batch."""
    from repro_torch.models.common import ShardLayout
    from repro_torch.train import make_train_step

    out = {}
    for arch, name in PORT_RUNS:
        rules, policy, moments, ef, wire = R.CASES[name]
        cfg, tcfg = R.config(arch, policy, moments, ef, wire)
        state = interop.train_state_from_numpy(
            run["inp"]["states"][R.state_key(arch, moments, ef)], "cpu")
        new, met = make_train_step(cfg, ShardLayout(), tcfg)(
            state, {k: torch.from_numpy(v) for k, v in run["inp"]["batch"].items()})
        out[f"{arch}/{name}"] = ({k: float(v) for k, v in met.items()},
                                 {k: v.detach().numpy() for k, v in flatten_with_paths(new)})
    return out


def _check_step(run_name, got_run, jmet, want, grad_tol=F32_GRAD_TOL, moved_max=MOVED):
    arch, name = run_name.split("/")
    policy = R.CASES[name][1]
    # the head's leaf: the embedding where the config ties them (Mamba2)
    head = ("lm_head", "embed") if R.config(arch)[0].tie_embeddings else ("lm_head",)
    gmet, got = got_run["metrics"], got_run["state"]
    assert gmet["tokens"] == jmet["tokens"]
    f32 = policy == "f32"
    np.testing.assert_allclose(gmet["loss"], jmet["loss"], rtol=LOSS_RTOL if f32 else 2e-5)
    np.testing.assert_allclose(gmet["grad_norm"], jmet["grad_norm"],
                               rtol=F32_NORM_RTOL if f32 else 1e-3)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k.startswith("params/"):
            assert np.abs(got[k] - w).max() <= 2 * R.LR + 1e-6, k
            if f32 and moved_max and not any(h in k for h in head):
                moved = int((np.abs(got[k] - w) > 1e-3 * R.LR).sum())
                assert moved <= max(1, moved_max * w.size), (k, moved, w.size)
        if f32 and k.startswith("opt/m/"):
            tol = 2 * 2.0 ** -8 if any(h in k for h in head) else grad_tol
            assert _rel(got[k], w) <= tol, (k, _rel(got[k], w), tol)


@pytest.mark.parametrize("run_name", [f"{a}/{c}" for a, c in JAX_RUNS])
def test_step_matches_reference(run, jax_steps, run_name):
    """One step on (2, 2) against the JAX package's single-device step
    (module docstring for the bounds); every rank reports the same
    metrics."""
    jmet, want = jax_steps[run_name]
    gmet = run["ranks"][0]["c"][run_name]["metrics"]
    for r in run["ranks"]:
        assert r["c"][run_name]["metrics"] == gmet
    jamba = run_name.startswith("jamba")
    _check_step(run_name, run["ranks"][0]["c"][run_name], jmet, want,
                REF_GRAD_TOL if jamba else F32_GRAD_TOL, None if jamba else MOVED)


@pytest.mark.parametrize("run_name", [f"{a}/{c}" for a, c in PORT_RUNS])
def test_step_matches_one_device(run, port_steps, run_name):
    """One step on (2, 2) against the port's single-device step: (c)'s
    bounds, every f32 first moment within F32_GRAD_TOL."""
    jmet, want = port_steps[run_name]
    _check_step(run_name, run["ranks"][0]["c"][run_name], jmet, want,
                moved_max=JAMBA_MOVED if run_name.startswith("jamba") else MOVED)


@pytest.mark.parametrize("run_name", [f"{a}/{c}" for a, c in RUNS])
def test_step_collectives_match_prediction(run, run_name):
    """Each rank's collectives in its step equal
    ``roofline.analysis.train_mesh_collectives``, kind by kind."""
    from repro_torch.launch.mesh import PlaceholderMesh
    from repro_torch.models.common import train_layout
    from repro_torch.roofline import analysis
    from repro_torch.train.train_step import state_shardings

    arch, name = run_name.split("/")
    rules, policy, moments, ef, wire = R.CASES[name]
    cfg, tcfg = R.config(arch, policy, moments, ef, wire)
    mesh = PlaceholderMesh(R.SHAPE, ("data", "model"))
    with sharding.use_mesh(mesh, sharding.RULESETS[rules]):
        sh = state_shardings(cfg, train_layout(), tcfg)
        want = analysis.train_mesh_collectives(cfg, tcfg, sh, mesh, policy, R.SEQ)
    for r in run["ranks"]:
        got = r["c"][run_name]["collectives"]
        assert {k: got.get(k, 0) for k in want} == want, (r["rank"], got, want)


def test_step_splits_experts_and_heads(run):
    """Under TRAIN_RULES the experts keep their ffn chunk and the SSM its
    heads (no whole gather over "model" of an expert, out_proj, A_log,
    D, dt_bias or the norm): the step's all-gathers carry fewer bytes
    than TRAIN_RULES_HYBRID's leaves alone would, and each rank's state
    holds half of each such leaf's "model" extent."""
    from repro_torch.launch.mesh import PlaceholderMesh
    from repro_torch.models.common import train_layout
    from repro_torch.train.train_step import state_shardings

    mesh = PlaceholderMesh(R.SHAPE, ("data", "model"))
    for arch in R.ARCHS:
        cfg, tcfg = R.config(arch)
        with sharding.use_mesh(mesh, sharding.TRAIN_RULES):
            layout = train_layout()
            sh = state_shardings(cfg, layout, tcfg)
            plans, split = sharding.leaf_plans(sh["params"], sp=True)
        plan = dict(flatten_with_paths(plans))
        for path, pl in plan.items():
            if any(path.endswith(s) for s in ("gate/w", "up/w", "down/w")):
                assert pl.split == "ffn" and "model" not in str(pl.gather), path
            if any(path.endswith(s) for s in ("out_proj/w", "A_log", "/D", "dt_bias",
                                              "mixer/norm")):
                assert pl.split == "ssm_heads" and "model" not in str(pl.gather), path
            if any(path.endswith(s) for s in ("in_proj/w", "conv_w", "conv_b")):
                assert pl.split is None and "model" in pl.sum_axes, path
            if path.endswith("router"):
                assert pl.split is None and pl.sum_axes == ("data", "model"), path
        with sharding.use_mesh(mesh, sharding.TRAIN_RULES_HYBRID):
            plans, _ = sharding.leaf_plans(state_shardings(cfg, train_layout(), tcfg)["params"],
                                           sp=False)
        for path, pl in flatten_with_paths(plans):
            if path.endswith("router"):
                assert pl.sum_axes == ("data",), path
            if any(path.endswith(s) for s in ("in_proj/w", "conv_w", "conv_b")):
                assert pl.sum_axes == ("data", "model"), path


# ------------------------------------------------------------------ (d)

@pytest.mark.parametrize("arch", list(R.ARCHS))
def test_placeholder_rank_does_the_predicted_share_of_products(arch):
    """The step's float products (tnn, int8 moments, EF) on a placeholder
    (2, 2) rank under TRAIN_RULES against one device's: the share
    ``train_step_flops`` predicts (a quarter, but for what each "model"
    rank repeats: Mamba2's B and C columns and C B^T of its one group),
    within 1%."""
    from repro_torch.launch.mesh import PlaceholderMesh
    from repro_torch.models.common import train_layout
    from repro_torch.roofline import analysis, op_stats
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import init_train_state, state_shardings

    cfg, tcfg = R.config(arch, "tnn", "int8", True, True)
    meta = torch.device("meta")

    def flops(mesh, rows):
        batch = {k: torch.empty((rows, R.SEQ), dtype=dt, device=meta)
                 for k, dt in (("tokens", torch.int32), ("labels", torch.int32),
                               ("mask", torch.float32))}
        with sharding.use_mesh(mesh, sharding.TRAIN_RULES):
            layout = train_layout()
            sh = None if mesh is None else state_shardings(cfg, layout, tcfg)
            state = init_train_state(torch.Generator(), cfg, layout, tcfg, device=meta,
                                     shardings=sh)
            step = make_train_step(cfg, layout, tcfg)
            step.prepare(sharding.active(), R.SEQ)
            with op_stats.counting((state, batch)) as st:
                step(state, batch)
        return st.dot_flops

    one = flops(None, R.BATCH)
    rank = flops(PlaceholderMesh(R.SHAPE, ("data", "model")), R.BATCH // 2)
    want = analysis.train_step_flops(cfg, R.BATCH // 2, R.SEQ, 2) / \
        analysis.train_step_flops(cfg, R.BATCH, R.SEQ)
    assert abs(rank / one - want) <= 0.01 * want, (rank, one, rank / one, want)
    if arch == "mamba2-1.3b":
        assert want > 0.255                 # the repeated B / C work shows


@pytest.mark.parametrize("rules", ["train", "train_hybrid", "train_fsdp"])
@pytest.mark.parametrize("policy", ["f32", "tnn"])
@pytest.mark.parametrize("arch", list(R.ARCHS))
def test_placeholder_collectives_match_prediction(arch, rules, policy):
    """A placeholder (2, 2) rank's collectives in one step (remat, int8
    moments and EF under tnn) are those
    ``roofline.analysis.train_mesh_collectives`` predicts, kind by kind."""
    from repro_torch.data.pipeline import mesh_rows
    from repro_torch.launch.mesh import PlaceholderMesh
    from repro_torch.models.common import train_layout
    from repro_torch.roofline import analysis
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import init_train_state, state_shardings

    cfg, tcfg = R.config(arch, policy, "int8" if policy == "tnn" else "f32", policy == "tnn",
                         policy == "tnn")
    meta = torch.device("meta")
    mesh = PlaceholderMesh(R.SHAPE, ("data", "model"))
    with sharding.use_mesh(mesh, sharding.RULESETS[rules]):
        layout = train_layout()
        sh = state_shardings(cfg, layout, tcfg)
        state = init_train_state(torch.Generator(), cfg, layout, tcfg, device=meta, shardings=sh)
        rows = len(mesh_rows(R.BATCH, *sharding.mesh_coord(mesh, sharding.batch_axes())))
        batch = {k: torch.empty((rows, R.SEQ), dtype=dt, device=meta)
                 for k, dt in (("tokens", torch.int32), ("labels", torch.int32),
                               ("mask", torch.float32))}
        mesh_mod.reset_collectives()
        make_train_step(cfg, layout, tcfg)(state, batch)
        got = mesh_mod.collectives()
        want = analysis.train_mesh_collectives(cfg, tcfg, sh, mesh, policy, R.SEQ)
    assert {k: got.get(k, 0) for k in want} == want


def test_layout_that_does_not_split_raises():
    """Under TRAIN_RULES an SSM whose heads, or an MoE whose expert FFN,
    do not divide the "model" axis raises with a clear message."""
    from repro_torch.launch.mesh import PlaceholderMesh
    from repro_torch.models.common import train_layout
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import init_train_state, state_shardings

    meta = torch.device("meta")
    mesh = PlaceholderMesh((1, 4), ("data", "model"))
    # 2 SSM heads of 64 (d_inner 128); an expert d_ff of 42
    for arch, kw, match in (("mamba2-1.3b", {"ssm_headdim": 64}, "SSM heads"),
                            ("qwen2-moe-a2.7b", {"d_ff": 42}, "expert FFN")):
        cfg, tcfg = R.config(arch)
        cfg = cfg.with_(**kw)
        with sharding.use_mesh(mesh, sharding.TRAIN_RULES):
            layout = train_layout()
            sh = state_shardings(cfg, layout, tcfg)
            state = init_train_state(torch.Generator(), cfg, layout, tcfg, device=meta,
                                     shardings=sh)
            batch = {k: torch.empty((8, R.SEQ), dtype=dt, device=meta)
                     for k, dt in (("tokens", torch.int32), ("labels", torch.int32),
                                   ("mask", torch.float32))}
            with pytest.raises(ValueError, match=match):
                make_train_step(cfg, layout, tcfg)(state, batch)


# ------------------------------------------------------------------ (e)

def test_faults_are_caught(run, jax_steps):
    """The sound steps are within the bounds of (c); the faulty ones are
    not: the norm's sum of squares not summed over "model" moves the loss
    by far more than LOSS_RTOL, the router's gradient summed over "model"
    under TRAIN_RULES_HYBRID (counted twice) moves its first moment by far
    more than F32_GRAD_TOL."""
    arch, name = R.FAULTS["norm"]
    jmet, _ = jax_steps[f"{arch}/{name}"]
    sound = run["ranks"][0]["c"][f"{arch}/{name}"]["metrics"]
    faulty = run["ranks"][0]["e"][f"{arch}/{name}"]["metrics"]
    assert abs(sound["loss"] / jmet["loss"] - 1) <= LOSS_RTOL
    assert abs(faulty["loss"] / jmet["loss"] - 1) > 100 * LOSS_RTOL, faulty
    arch, name = R.FAULTS["router"]
    _, want = jax_steps[f"{arch}/{name}"]
    sound = run["ranks"][0]["c"][f"{arch}/{name}"]["state"]
    faulty = run["ranks"][0]["e"][f"{arch}/{name}"]["state"]
    routers = [k for k in want if k.startswith("opt/m/") and k.endswith("router")]
    assert routers
    for k in routers:
        assert _rel(sound[k], want[k]) <= F32_GRAD_TOL, k
        assert _rel(faulty[k], want[k]) > 100 * F32_GRAD_TOL, (k, _rel(faulty[k], want[k]))
