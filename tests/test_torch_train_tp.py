"""Tensor- and sequence-parallel training on the CPU: 4 ranks of a gloo
world on the (2, 2) ("data", "model") mesh, held to one device.

One module fixture writes the inputs (operands made with numpy; the JAX
package's initial train states of a small config: 2 layers, d_model 128,
4/2 heads, d_ff 256, vocab 512, float32 activations, remat; a batch of 8
x 64), starts ``tests/torch_train_tp_ranks.py`` as 4 ranks
(``launch.mesh.run_ranks``, a hard timeout) and loads what they wrote.

Bounds:

* (a) exact (``torch.equal``): with the statistics passed in, a
  column-parallel projection's output is one device's n slice and a
  row-parallel one's is one device's rows of the rank's sequence shard
  (its int32 partial counts sum to one device's core exactly);
* (b) the sequence gather and reduce-scatter move float64 values: exact,
  and so are their gradients; the vocab-parallel embedding's rows are
  exact, its gradient within ``GRAD_RTOL`` (repeated ids add in another
  order); the
  vocab-parallel loss sums its exponentials and target logits in another
  order than one device (float32): the loss within ``LOSS_RTOL``, the
  hidden rows' gradients within ``GRAD_RTOL`` relative in norm and the
  head's (a bf16 operand, rounded on each of the 2 batch shards before
  their sum) within ``2 * 2**-8``;
* (c) one step against the JAX package's single-device step on the same
  weights and global batch.  ``f32`` (float32 projections, float32
  masters on the wire): the loss within ``LOSS_RTOL``, the grad norm
  within ``F32_NORM_RTOL``, every first moment (``0.1 g``) within
  ``F32_GRAD_TOL`` relative but the head's (its cotangent rounds to bf16
  on each batch shard before their sum: ``n * 2**-8`` for ``n`` shards),
  every master within ``2 lr`` elementwise and at most one element in a
  thousand of a leaf moved by more than ``1e-3 lr`` (a gradient within
  rounding of zero whose sign flips).  ``tnn`` (the bf16 wire, int8
  moments, EF; ``tests/test_torch_train_mesh.py``'s kind): the loss within
  ``2e-5``, the grad norm within ``1e-3``, every master within ``2 lr``;
* (d) the step's float products on a placeholder (2, 2) rank are a
  quarter of one device's, within 1%;
* (e) the f32 step whose norm scales sum their gradients over the batch
  axes only, not over "model" too, is caught: their first moments miss
  the other sequence shard's part, far outside ``F32_GRAD_TOL``.
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
from repro_torch.models import model as model_mod
from repro_torch.models.common import ShardLayout
from repro_torch.parallel import sharding
from repro_torch.train.loss import xent_loss
from repro_torch.tree import flatten_with_paths

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_train_tp_ranks as R  # noqa: E402

WORLD = 4
RANK_TIMEOUT_S = 240
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
F32_NORM_RTOL = 1e-4
F32_GRAD_TOL = 1e-4


def _jcfg(policy):
    return jget_smoke(R.ARCH).with_(d_model=128, d_ff=256, dtype=jnp.float32, remat=True,
                                    quant_policy=policy)


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


def _inputs(rng):
    f32 = np.float32

    def normal(*shape, dtype=f32):
        return rng.standard_normal(shape).astype(dtype)

    proj = {}
    for mode in R.MODES:
        x, w_col = normal(R.BATCH, R.SEQ, 128), normal(128, 256) * f32(0.1)
        h, w_row = normal(R.BATCH, R.SEQ, 256), normal(256, 128) * f32(0.1)
        ast_col, wst_col = _stats(x, w_col, mode)
        ast_row, wst_row = _stats(h, w_row, mode)
        proj[mode] = {"x": x, "w_col": w_col, "h": h, "w_row": w_row, "ast_col": ast_col,
                      "wst_col": wst_col, "ast_row": ast_row, "wst_row": wst_row}
    f64 = np.float64
    bound = {"x": normal(R.BATCH, R.SEQ, 16, dtype=f64),
             "cot": normal(2, R.BATCH, R.SEQ, 16, dtype=f64),
             "part": normal(2, R.BATCH, R.SEQ, 16, dtype=f64),
             "zcot": normal(R.BATCH, R.SEQ, 16, dtype=f64),
             "embed": normal(512, 128), "tokens": rng.integers(0, 500, (R.BATCH, R.SEQ)),
             "ecot": normal(R.BATCH, R.SEQ, 128), "hidden": normal(R.BATCH, R.SEQ, 128),
             "head": normal(128, 512) * f32(0.1),
             "labels": rng.integers(0, 500, (R.BATCH, R.SEQ)).astype(np.int32),
             "mask": (rng.random((R.BATCH, R.SEQ)) < 0.8).astype(f32)}
    return proj, bound


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("train_tp"))
    rng = np.random.default_rng(11)
    proj, bound = _inputs(rng)
    jstates = {}
    for rules, policy, moments, ef, wire in R.CASES.values():
        if (moments, ef) not in jstates:
            jstates[(moments, ef)] = jts.init_train_state(
                jax.random.PRNGKey(0), _jcfg("f32"), JLayout(tp=1), _jtcfg(moments, ef, wire))
    batch = SyntheticLM(vocab_size=512, seq_len=R.SEQ, global_batch=R.BATCH,
                        seed=0).batch_at(DataState(0, 0))
    states = {R.state_key(m, ef): interop.train_state_to_numpy(interop.train_state_from_numpy(
        jax.tree.map(np.asarray, s), device="cpu")) for (m, ef), s in jstates.items()}
    inp = {"proj": proj, "bound": bound, "states": states, "batch": batch}
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(os.path.dirname(HERE), "src"),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    res = mesh_mod.run_ranks([sys.executable, os.path.join(HERE, "torch_train_tp_ranks.py"), d],
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


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("mode", R.MODES)
def test_projection_forward_exact(run, mode):
    """Column-parallel: each rank's output is one device's n slice of its
    rows; row-parallel: one device's rows of the rank's sequence shard,
    ``torch.equal``, with the same statistics given to both."""
    a = run["inp"]["proj"][mode]
    tensor = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) and v.ndim else v
              for k, v in a.items() if not k.startswith(("ast", "wst"))}

    def st(d):
        return {k: torch.tensor(v) for k, v in d.items()}

    def one(x, w, ast, wst):
        qt = QTensor.from_dense(w, QuantMode(mode), stats=st(wst))
        return ops.qmm(x.reshape(-1, x.shape[-1]), qt, backend="torch", act_stats=st(ast))

    col = one(tensor["x"], tensor["w_col"], a["ast_col"], a["wst_col"]).reshape(R.BATCH, R.SEQ, -1)
    row = one(tensor["h"], tensor["w_row"], a["ast_row"], a["wst_row"]).reshape(R.BATCH, R.SEQ, -1)
    for r in run["ranks"]:
        rows, j, got = r["a"]["rows"], r["a"]["model"], r["a"]["out"][mode]
        want_col = _seq(col[rows], j, dim=2).reshape(-1, col.shape[-1] // 2)
        assert torch.equal(got["col"], want_col)
        want_row = _seq(row[rows], j).reshape(-1, row.shape[-1])
        assert torch.equal(got["row"], want_row)


# ------------------------------------------------------------------ (b)

def test_sequence_gather_and_reduce_scatter(run):
    """``tp_enter`` gathers the whole sequence (its backward sums the
    ranks' cotangents into the shard); ``tp_reduce`` sums the ranks'
    partials into the shard (its backward gathers the cotangent): float64
    values and gradients, exact."""
    b = {k: torch.from_numpy(v) for k, v in run["inp"]["bound"].items()}
    for r in run["ranks"]:
        rows, j, got = r["b"]["rows"], r["b"]["model"], r["b"]["out"]
        assert torch.equal(got["enter"]["y"], b["x"][rows])
        assert torch.equal(got["enter"]["gx"], _seq(b["cot"][0][rows] + b["cot"][1][rows], j))
        assert torch.equal(got["reduce"]["z"], _seq(b["part"][0][rows] + b["part"][1][rows], j))
        assert torch.equal(got["reduce"]["gp"], b["zcot"][rows])


def test_vocab_parallel_embedding(run):
    """Ids outside a rank's vocab slice look up zeros; the partial rows,
    summed into the rank's sequence shard, are one device's rows exactly,
    and the slice's gradient is one device's over the rank's rows within
    GRAD_RTOL (the lookup's backward adds repeated ids in another order)."""
    b = run["inp"]["bound"]
    cfg = R.config()[0]
    table = torch.from_numpy(b["embed"]).requires_grad_(True)
    for r in run["ranks"]:
        rows, j, got = r["b"]["rows"], r["b"]["model"], r["b"]["out"]["embed"]
        x = model_mod._embed({"embed": table}, {"tokens": torch.from_numpy(b["tokens"])[rows]},
                             cfg)
        (g,) = torch.autograd.grad((x * torch.from_numpy(b["ecot"])[rows]).sum(), table)
        assert torch.equal(got["x"], _seq(x.detach(), j))
        assert _rel(got["g"], _seq(g, j, dim=0)) <= GRAD_RTOL


def test_vocab_parallel_loss_and_gradients(run):
    """The vocab-parallel cross-entropy (z-loss on) against one device's on
    the whole batch: the loss within LOSS_RTOL, the token count exact, the
    hidden rows' gradients within GRAD_RTOL and the head's, summed over the
    batch shards, within the bf16 rounding of each shard's (compared in
    float64)."""
    b = {k: torch.from_numpy(v) for k, v in run["inp"]["bound"].items()}
    cfg = R.config()[0]
    hidden, head = b["hidden"].requires_grad_(True), b["head"].requires_grad_(True)
    loss, met = xent_loss({"lm_head": {"w": head}}, hidden, {"labels": b["labels"],
                                                            "mask": b["mask"]},
                          cfg, ShardLayout(), seq_chunk=32, z_loss=1e-4)
    gh, gw = torch.autograd.grad(loss, (hidden, head))
    heads = {}
    for r in run["ranks"]:
        rows, j, got = r["b"]["rows"], r["b"]["model"], r["b"]["out"]["loss"]
        np.testing.assert_allclose(got["loss"], float(loss.detach()), rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["nll"], float(met["nll"]), rtol=LOSS_RTOL)
        assert got["tokens"] == float(met["tokens"])
        assert _rel(got["g_hidden"], _seq(gh[rows], j)) <= GRAD_RTOL
        heads[j] = heads.get(j, 0) + got["g_head"].to(torch.float64)
    for j, g in heads.items():
        # the head is a bf16 operand: each batch shard's gradient rounds to
        # bf16 before the sum (2**-8 relative for each of the 2 shards)
        assert _rel(g, _seq(gw, j, dim=1)) <= 2 * 2.0 ** -8


# ------------------------------------------------------------------ (c)

@pytest.fixture(scope="module")
def jax_steps(run):
    """The JAX package's single-device step of every case (one per policy:
    the rules do not reach one device)."""
    done, out = {}, {}
    for name, (rules, policy, moments, ef, wire) in R.CASES.items():
        key = (policy, moments, ef, wire)
        if key not in done:
            new, met = jts.make_train_step(_jcfg(policy), JLayout(tp=1),
                                           _jtcfg(moments, ef, wire))(
                run["jstates"][(moments, ef)],
                {k: jnp.asarray(v) for k, v in run["inp"]["batch"].items()})
            done[key] = ({k: float(v) for k, v in met.items()},
                         {k: v.numpy() for k, v in
                          flatten_with_paths(interop.train_state_from_numpy(
                              jax.tree.map(np.asarray, new), device="cpu"))})
        out[name] = done[key]
    return out


def _shards(rules):
    return 4 if rules == "train_fsdp" else 2


@pytest.mark.parametrize("name", list(R.CASES))
def test_step_matches_reference(run, jax_steps, name):
    """One step on (2, 2) against the JAX package's single-device step
    (module docstring for the bounds)."""
    rules, policy, moments, ef, wire = R.CASES[name]
    jmet, want = jax_steps[name]
    gmet = run["ranks"][0]["c"][name]["metrics"]
    got = run["ranks"][0]["c"][name]["state"]
    for r in run["ranks"]:
        assert r["c"][name]["metrics"] == gmet          # every rank reports the same
    assert gmet["tokens"] == jmet["tokens"]
    f32 = policy == "f32"
    np.testing.assert_allclose(gmet["loss"], jmet["loss"], rtol=LOSS_RTOL if f32 else 2e-5)
    np.testing.assert_allclose(gmet["grad_norm"], jmet["grad_norm"],
                               rtol=F32_NORM_RTOL if f32 else 1e-3)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k.startswith("params/"):
            assert np.abs(got[k] - w).max() <= 2 * R.LR + 1e-6, k
            if f32 and "lm_head" not in k:
                moved = np.abs(got[k] - w) > 1e-3 * R.LR
                assert moved.mean() <= 1e-3, (k, int(moved.sum()))
        if f32 and k.startswith("opt/m/"):
            tol = _shards(rules) * 2.0 ** -8 if "lm_head" in k else F32_GRAD_TOL
            assert _rel(got[k], w) <= tol, (k, _rel(got[k], w), tol)


def test_step_splits_over_model(run):
    """Under TRAIN_RULES the step gathers the model's leaves over "data"
    only and moves the sequence over "model"; under TRAIN_RULES_FSDP every
    sharded leaf is gathered over both axes and nothing else moves."""
    c = run["ranks"][0]["c"]
    # 9 leaves shard over "data" (embed, wq, wk, wv, wo, gate, up, down,
    # lm_head) and "model"; under TRAIN_RULES 3 norm scales over "model"
    # too (their "conv_dim")
    fsdp = c["fsdp_f32"]["collectives"]
    assert fsdp["all_gather"] == fsdp["reduce_scatter"] == 9 * 2
    train = c["train_f32"]["collectives"]
    layers = 2
    # gathers: the 12 leaves once; per layer the attention and FFN inputs in
    # the forward and the remat recompute, and the backward of wo and down;
    # the head's input and the embedding's backward
    assert train["all_gather"] == 12 + layers * (2 + 2 + 2) + 1 + 1
    # reduce-scatters: the 12 leaves' gradients; per layer wo and down in the
    # forward, wo in the recompute (it stops after the last op whose saved
    # tensors the backward needs, down's product), the backward of the two
    # gathers; the embedding and the head input's backward
    assert train["reduce_scatter"] == 12 + layers * (2 + 1 + 2) + 1 + 1


# ------------------------------------------------------------------ (d)

def test_placeholder_rank_does_a_quarter_of_the_products():
    """The step's float products on a placeholder (2, 2) rank (2 of the 8
    rows, half the heads, FFN and vocab) are 0.25 of one device's, within
    1%."""
    from repro_torch.launch.mesh import PlaceholderMesh
    from repro_torch.models.common import train_layout
    from repro_torch.roofline import op_stats
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import init_train_state, state_shardings

    cfg, tcfg = R.config("tnn", "int8", True, True)
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
    rank = flops(PlaceholderMesh((2, 2), ("data", "model")), R.BATCH // 2)
    assert abs(rank / one - 0.25) <= 0.01 * 0.25, (rank, one, rank / one)


@pytest.mark.parametrize("rules", ["train", "train_hybrid", "train_fsdp"])
@pytest.mark.parametrize("policy", ["f32", "tnn", "int8", "int4"])
def test_placeholder_collectives_match_prediction(rules, policy):
    """A placeholder (2, 2) rank's collectives in one step (remat, int8
    moments under tnn) are those ``roofline.analysis.train_mesh_collectives``
    predicts from the shardings, kind by kind: the sequence-parallel
    gathers and reduce-scatters under TRAIN_RULES, the all-reduce pairs
    under TRAIN_RULES_HYBRID, whole gathers under TRAIN_RULES_FSDP; under
    the affine policies one max for each activation range and each
    weight's grid, the column-parallel ones' too."""
    from repro_torch.data.pipeline import mesh_rows
    from repro_torch.launch.mesh import PlaceholderMesh
    from repro_torch.models.common import train_layout
    from repro_torch.roofline import analysis
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import init_train_state, state_shardings

    cfg, tcfg = R.config(policy, "int8" if policy == "tnn" else "f32", policy == "tnn")
    meta = torch.device("meta")
    mesh = PlaceholderMesh((2, 2), ("data", "model"))
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


# ------------------------------------------------------------------ (e)

def test_norm_gradients_need_the_model_sum(run, jax_steps):
    """The norm scales see one sequence shard per "model" rank: summed over
    the batch axes and "model" their first moments are within F32_GRAD_TOL
    of the reference's; summed over the batch axes only (the fault) they
    are far outside it, and the bound catches it."""
    want = jax_steps["train_f32"][1]
    sound = run["ranks"][0]["c"]["train_f32"]["state"]
    faulty = run["ranks"][0]["e"]["train_f32"]["state"]
    norms = [k for k in want if k.startswith("opt/m/") and k.endswith("norm/scale")]
    assert len(norms) == 3
    for k in norms:
        assert _rel(sound[k], want[k]) <= F32_GRAD_TOL, k
        assert _rel(faulty[k], want[k]) > 100 * F32_GRAD_TOL, (k, _rel(faulty[k], want[k]))
