"""The port's serving mesh on the CPU: 4 ranks of a gloo world, held to the
JAX package's single-device results.

One module-scoped fixture writes the inputs (the reference's packed
weights and activation statistics, its smoke LM parameters, as numpy),
starts ``tests/torch_mesh_ranks.py`` as 4 ranks (``launch.mesh.run_ranks``,
a hard timeout that kills overrunning ranks, so a hang fails these tests
and never the suite's limit) and loads what each rank wrote.  The
reference's own mesh tests (``tests/sharded_check.py``) compare against
its single-device oracle; these do the same, across the two packages:

* n-, k- and n+k-sharded ``qmm`` (BNN/TNN/TBN; backends "torch" and
  "dense"; M, K, N = 5, 250, 64, so 6 pad bits sit in the last k shard)
  ``array_equal`` to the reference's single-device ``ops.qmm`` without a
  bias; with a bias ``array_equal`` to the port's single-device ``qmm``
  and within one float32 ULP of the largest pre-bias value of the
  reference's (XLA contracts its last multiply and the add into an FMA;
  the port never does, as ``test_torch_gemm.py`` states);
* every tensor handed to ``all_reduce`` by the k-sharded products is an
  integer tensor; the psum counters hold the expected counts and bytes;
* cout-sharded ``qconv`` ``array_equal`` to the reference's ``ops.qconv``;
* the mesh ``Engine`` on (2, 2) (the reference's smoke tinyllama with
  ``d_model=128``, ``d_ff=256``, f32, ``tnn``, and its prompts) decodes
  the reference's single-device engine's tokens; the watchdog flags the
  silent rank 3; ``rebuild_after_loss`` with requests in flight gives a
  (1, 2) mesh and the same tokens;
* ``Mesh.agree`` raises ``MeshDesyncError`` on every rank when one rank
  differs, and ``Mesh.from_first`` gives rank 0's value everywhere;
* on 2 ranks (``--quarantine``): one fault plan on both ranks gives the
  single-device engine's results, a failed tick quarantined on every
  rank; a fault on one rank only ends both ranks' ``run()`` in an error
  within the group's timeout;
* ``launch.serve`` on 2 ranks serves the single-device tokens, and
  ``--production`` raises the reference's error below 256 ranks;
* ``pick_backend`` takes NCCL exactly when the ranks on this host each
  have a card.  (The non-mesh guards are checked in
  ``test_torch_serving.py``.)
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
from repro.core import quantize as jq
from repro.core.conv import pack_conv_filters as jpack_conv
from repro.kernels import conv_fused as jconv_fused
from repro.kernels import ops as jops
from repro.kernels.modes import QuantMode as JMode
from repro.kernels.qtensor import QTensor as JQTensor
from repro.models import model as jmodel
from repro.models.common import ShardLayout as JLayout
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplerConfig as JSampler
from repro.serving import ServeConfig as JServe
from repro_torch.launch import mesh as mesh_mod

M, K, N = 5, 250, 64
MODES = ["bnn", "tnn", "tbn"]
CASES = ["n", "k", "nk"]
BACKENDS = ["torch", "dense"]
WORLD = 4
RANK_TIMEOUT_S = 240
PROMPTS = [[3, 1, 4], [1, 5, 9, 2]]
INFLIGHT = [[3, 1, 4], [1, 5, 9, 2], [2, 7, 1], [8, 2, 8, 1]]
HERE = os.path.dirname(os.path.abspath(__file__))


def _jax_stats(x, mode):
    xa = jops.quantize_activations(jnp.asarray(x), JMode(mode))
    stats = {"scale": np.asarray(xa["scale"])}
    if mode != "bnn":
        stats["thr"] = np.asarray(jq.ternary_threshold(jnp.asarray(x)))
    return stats


def _jax_decode(eng, prompts):
    for uid, p in enumerate(prompts):
        eng.submit(JRequest(uid=uid, prompt=np.asarray(p), max_new_tokens=4))
    return {uid: (r.status, list(r.tokens)) for uid, r in eng.run().items()}


@pytest.fixture(scope="module")
def reference():
    """The inputs and the reference's single-device results."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    bias = rng.standard_normal((N,)).astype(np.float32)
    inp = {"x": x, "qmm": {}, "qconv": {}}
    want = {"qmm": {}, "qconv": {}}
    for mode in MODES:
        stats = _jax_stats(x, mode)
        for b in (None, bias):
            jqt = JQTensor.from_dense(jnp.asarray(w), JMode(mode),
                                      bias=None if b is None else jnp.asarray(b))
            key = (mode, b is not None)
            inp["qmm"][key] = {"payload": {k: np.asarray(v) for k, v in jqt.payload.items()},
                               "scale": np.asarray(jqt.scale), "bias": b,
                               "shape": tuple(jqt.shape), "stats": stats}
            # both packages quantize x with the same statistics
            want["qmm"][key] = np.asarray(jops.qmm(
                jnp.asarray(x), jqt, backend="xla",
                act_stats={k: jnp.asarray(v) for k, v in stats.items()}))
    want["bias"] = bias

    rng = np.random.default_rng(2)
    kh, kw_, cin, cout = 3, 3, 5, 16
    cx = rng.standard_normal((2, 6, 6, cin)).astype(np.float32)
    f = rng.standard_normal((kh, kw_, cin, cout)).astype(np.float32)
    inp["conv_x"] = cx
    for mode in MODES:
        jqt = jpack_conv(jnp.asarray(f), JMode(mode))
        stats = jconv_fused.conv_act_stats(jnp.asarray(cx), JMode(mode), kh, kw_, 1, "SAME")
        inp["qconv"][mode] = {"payload": {k: np.asarray(v) for k, v in jqt.payload.items()},
                              "scale": np.asarray(jqt.scale), "shape": tuple(jqt.shape),
                              "geometry": tuple(jqt.geometry),
                              "stats": {k: np.asarray(v) for k, v in stats.items()}}
        want["qconv"][mode] = np.asarray(jops.qconv(jnp.asarray(cx), jqt, backend="xla",
                                                    act_stats=stats))

    jcfg = jget_smoke("tinyllama-1.1b").with_(dtype=jnp.float32, quant_policy="tnn",
                                              d_model=128, d_ff=256)
    params = jmodel.init_lm(jax.random.PRNGKey(0), jcfg, JLayout(tp=1))
    inp["params"] = jax.tree.map(np.asarray, params)
    inp["prompts"], inp["inflight_prompts"] = PROMPTS, INFLIGHT
    base = dict(num_slots=2, max_len=16, prefill_bucket=8,
                sampler=JSampler(temperature=0.0), pack_params=True)
    want["single"] = _jax_decode(JEngine(params, jcfg, JLayout(tp=1), JServe(**base)),
                                 PROMPTS)
    want["single_inflight"] = _jax_decode(
        JEngine(params, jcfg, JLayout(tp=1), JServe(**base)), INFLIGHT)
    return inp, want


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """Run the 4 ranks once; each rank's report, by rank."""
    d = str(tmp_path_factory.mktemp("mesh"))
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(reference[0], f)
    env = _rank_env()
    res = mesh_mod.run_ranks([sys.executable, os.path.join(HERE, "torch_mesh_ranks.py"), d],
                             WORLD, timeout_s=RANK_TIMEOUT_S, env=env,
                             log_dir=os.path.join(d, "logs"))
    logs = mesh_mod.rank_logs(res)
    reports = {}
    for r in range(WORLD):
        path = os.path.join(d, f"rank{r}.pt")
        if os.path.exists(path):
            reports[r] = torch.load(path, weights_only=False)
    return {"results": res, "logs": logs, "reports": reports}


@pytest.fixture(scope="module")
def quarantine(reference, tmp_path_factory):
    """``torch_mesh_ranks.py --quarantine`` on 2 ranks; each rank's report."""
    d = str(tmp_path_factory.mktemp("quarantine"))
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(reference[0], f)
    res = mesh_mod.run_ranks([sys.executable, os.path.join(HERE, "torch_mesh_ranks.py"),
                              "--quarantine", d], 2, timeout_s=RANK_TIMEOUT_S, env=_rank_env(),
                             log_dir=os.path.join(d, "logs"))
    assert [r["returncode"] for r in res] == [0, 0], mesh_mod.rank_logs(res)
    return [torch.load(os.path.join(d, f"quarantine{r}.pt"), weights_only=False)
            for r in range(2)]


def _rank_env():
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(HERE), "src")
    env["PYTHONPATH"] = os.pathsep.join([src] + [p for p in env.get("PYTHONPATH", "").split(
        os.pathsep) if p])
    env.setdefault("OMP_NUM_THREADS", "1")
    return env


def _report(ranks, r):
    assert r in ranks["reports"], f"rank {r} wrote no report\n{ranks['logs']}"
    rep = ranks["reports"][r]
    assert not rep["errors"], "\n".join(rep["errors"])
    return rep


def test_ranks_exit_cleanly(ranks):
    assert [res["returncode"] for res in ranks["results"]] == [0] * WORLD, ranks["logs"]
    assert sorted(ranks["reports"]) == list(range(WORLD))
    coords = {tuple(sorted(_report(ranks, r)["coords"].items())) for r in range(WORLD)}
    assert len(coords) == WORLD             # every (data, model) position once


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_qmm_matches_jax_single_device(reference, ranks, mode, backend, case, bias):
    want = reference[1]["qmm"][(mode, bias)]
    for r in range(WORLD):
        rep = _report(ranks, r)
        got = rep["qmm"][(mode, bias, backend, case)]
        np.testing.assert_array_equal(got, rep["single"][(mode, bias, backend)],
                                      err_msg=f"rank {r}: port single-device")
        if not bias:
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
        else:
            one_ulp = np.finfo(np.float32).eps * np.abs(want - reference[1]["bias"]).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=one_ulp, err_msg=f"rank {r}")


def test_shard_plans_and_local_slices(ranks):
    rep = _report(ranks, 0)
    for mode in MODES:
        # (2, 2): n 64 over model -> 32; 8 words over model -> 4, over data -> 4
        assert rep["plans"][(mode, "n")][:2] == ("model", None)
        assert rep["plans"][(mode, "k")][:2] == (None, "model")
        assert rep["plans"][(mode, "nk")][:2] == ("model", "data")
        assert {p[2] for label, p in rep["plans"].items()} == {"int16"}   # 2*256 < 2**15
        assert rep["local_shapes"][(mode, "n")] == (32, 8)
        assert rep["local_shapes"][(mode, "k")] == (64, 4)
        assert rep["local_shapes"][(mode, "nk")] == (32, 4)


def test_k_shard_all_reduce_moves_integers(ranks):
    # per (mode, bias, backend): the k case reduces (M, 64) partials, the
    # n+k case (M, 32); int32 on the wire
    n_red = len(MODES) * 2 * len(BACKENDS) * 2
    nbytes = len(MODES) * 2 * len(BACKENDS) * (M * 64 + M * 32) * 4
    for r in range(WORLD):
        rep = _report(ranks, r)
        assert rep["all_reduce_dtypes"] == ["torch.int32"] * n_red, rep["all_reduce_dtypes"]
        assert rep["collectives"]["all_reduce"] == n_red
        assert rep["collectives"]["all_reduce_bytes"] == nbytes
        # gathers: the n and n+k cases, (M, 32) float32 slices
        assert rep["collectives"]["all_gather"] == len(MODES) * 2 * len(BACKENDS) * 2
        counters = rep["psum_counters"]
        if counters:                        # obs on (REPRO_OBS unset)
            total = {k: v for k, v in counters.items() if k[0] == "repro_mesh_psum_total"}
            assert all(dict(k[1:])["acc_dtype"] == "int32" for k in total)
            assert sum(total.values()) == n_red
            assert sum(v for k, v in counters.items()
                       if k[0] == "repro_mesh_psum_wire_bytes_total") == nbytes


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_qconv_matches_jax_single_device(reference, ranks, mode, backend):
    want = reference[1]["qconv"][mode]
    for r in range(WORLD):
        got = _report(ranks, r)["qconv"][(mode, backend)]
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")


def test_mesh_engine_decodes_single_device_tokens(reference, ranks):
    want = reference[1]["single"]
    assert all(s == "ok" for s, _ in want.values())
    for r in range(WORLD):
        rep = _report(ranks, r)
        assert rep["engine_single"] == want, f"rank {r}: port single-device engine"
        assert rep["mesh"] == want, f"rank {r}: mesh engine"
        assert rep["mesh_again"] == want, f"rank {r}: second batch"
        # wq/wk/wv n+k, gate/up n, wo/down k on (2, 2) (SERVE_RULES_LOWBIT)
        assert rep["pspecs"] == sorted({str(("model", "data")), str(("model", None)),
                                        str((None, "model"))})


def test_watchdog_flags_silent_rank(ranks):
    for r in range(WORLD):
        assert _report(ranks, r)["dead"] == [WORLD - 1]


def test_rebuild_after_loss_migrates_inflight_requests(reference, ranks):
    want = reference[1]["single_inflight"]
    for r in range(WORLD):
        rep = _report(ranks, r)
        busy, queued = rep["busy_before"]
        assert busy and queued            # slots decoding and requests queued
        assert rep["migrated"] == sorted(want)
        assert rep["single_inflight"] == want
        if r >= 2:                         # (2, 2) -> (1, 2) keeps ranks 0, 1
            assert rep["rebuilt"] is None
            continue
        new = rep["rebuilt"]
        assert new["shape"] == (1, 2) and new["ranks"] == [0, 1]
        assert new["queue"] == sorted(want)
        assert new["results"] == want


@pytest.mark.parametrize("device,env,cards,want", [
    ("cuda", {"LOCAL_WORLD_SIZE": "4", "WORLD_SIZE": "256"}, 8, "nccl"),  # many hosts
    ("cuda", {"LOCAL_WORLD_SIZE": "8", "WORLD_SIZE": "256"}, 4, "gloo"),  # cards shared
    ("cuda", {"WORLD_SIZE": "4"}, 1, "gloo"),      # run_ranks-style: 4 ranks, one card
    ("cuda", {"WORLD_SIZE": "4"}, 4, "nccl"),      # one host, a card each
    ("cpu", {"LOCAL_WORLD_SIZE": "1", "WORLD_SIZE": "1"}, 8, "gloo"),
])
def test_pick_backend_counts_the_ranks_on_this_host(monkeypatch, device, env, cards, want):
    """NCCL exactly when the ranks on this host (``LOCAL_WORLD_SIZE``,
    else ``WORLD_SIZE``) each have a card: a world that spans hosts has
    more ranks than one host has cards and still gets NCCL."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    local = mesh_mod._local_world_size()
    assert local == int(env.get("LOCAL_WORLD_SIZE", env["WORLD_SIZE"]))
    assert mesh_mod.pick_backend(torch.device(device), local) == want


def test_agreement_helpers(ranks):
    for r in range(WORLD):
        rep = _report(ranks, r)
        assert rep["desync_raised"], f"rank {r}"
        assert rep["from_first"] == 100.0


def test_launch_serve_on_two_ranks_matches_one_device(tmp_path, capsys):
    from repro_torch.launch import serve

    args = ["--smoke", "--device", "cpu", "--quant", "tnn", "--requests", "3", "--slots", "2",
            "--new-tokens", "3", "--temperature", "0"]
    want = {u: r.tokens for u, r in serve.main(args).items()}
    capsys.readouterr()
    res = mesh_mod.run_ranks([sys.executable, "-m", "repro_torch.launch.serve", *args], 2,
                             timeout_s=120, env=_rank_env(), log_dir=str(tmp_path))
    logs = mesh_mod.rank_logs(res)
    assert [r["returncode"] for r in res] == [0, 0], logs
    with open(res[0]["log"]) as f:
        out = f.read()
    assert "[mesh] backend gloo: 2 ranks on cpu" in out
    assert "on 2 ranks, mesh (1, 2) (gloo)" in out
    for uid in range(3):
        assert f"  req {uid}: {want[uid][:12]} ..." in out, out


def test_launch_serve_production_needs_256_ranks():
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="need 256 devices for mesh"):
        serve.main(["--smoke", "--device", "cpu", "--production"])


def test_offline_sweep_plans_local_problems(reference, ranks):
    """``autotune="offline"`` on the (2, 2) mesh also sweeps what each
    rank's kernels see (``qmm_mesh.local_dims``): wq n 128 -> 64 over
    "model", its 4 words -> 2 over "data" (unfused); gate n 256 -> 128
    (fused); down's 8 words -> 4 (unfused); at the m buckets of the decode
    m (2 slots) and the prefill buckets (8, 16): 8 and 16."""
    want = {"tnn/cuda/unfused/cpu/m{m}/n64/k64", "tnn/cuda/fused/cpu/m{m}/n128/k128",
            "tnn/cuda/unfused/cpu/m{m}/n128/k128"}
    for r in range(WORLD):
        rep = _report(ranks, r)
        keys = set(rep["tuned_keys"])
        for m in (8, 16):
            for k in want:
                assert k.format(m=m) in keys, (r, k.format(m=m), sorted(keys))
        assert rep["tuned"] == reference[1]["single"]


def test_mesh_engine_quarantines_like_single_device(quarantine):
    """One fault plan armed on both ranks of a (1, 2) mesh engine
    (``device.loss`` raises in tick 2, ``logits.nan`` poisons a row in the
    4th decode; each point is hit once per tick on any engine): every rank
    agrees the tick failed and quarantines it, and the results (statuses
    and tokens) are the single-device engine's under the same plan."""
    for rep in quarantine:
        assert rep["mesh"] == rep["single"]
        assert rep["mesh_report"] == rep["single_report"]
        statuses = {s for s, _ in rep["mesh"].values()}
        assert "error" in statuses and "numeric_error" in statuses, rep["mesh"]
    assert quarantine[0]["mesh"] == quarantine[1]["mesh"]


def test_mesh_engine_one_rank_failure_raises_within_timeout(quarantine):
    """``device.loss`` armed on rank 1 only: rank 1 fails the tick, rank 0
    waits in a collective rank 1 never joins.  Both ranks' ``run()`` raise
    (``MeshDesyncError`` or the collective's timeout error) within a few
    of the group's 5 s timeouts, never hang."""
    from torch_mesh_ranks import QUARANTINE_TIMEOUT_S

    for rep in quarantine:
        kind, msg, secs = rep["one_rank"]
        assert kind in ("MeshDesyncError", "RuntimeError", "DistBackendError"), (kind, msg)
        assert secs < 4 * QUARANTINE_TIMEOUT_S, (kind, msg, secs)
