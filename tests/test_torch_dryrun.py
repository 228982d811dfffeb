"""The port's dry-run (``launch/specs.py``, ``launch/dryrun.py``,
``roofline/op_stats.py``, the kernel records on ``meta``, the
``PlaceholderMesh``) against the JAX package and against real runs, on
the CPU at smoke size.  Every comparison is exact unless it says
otherwise:

* ``global_batch_spec`` and ``cache_logical_axes`` (every cache format)
  equal to the reference's;
* ``cell_artifacts`` of the ten smoke configs x train / prefill / decode
  without a mesh: each argument's leaf paths, shapes and dtypes equal to
  the reference's ``jax.eval_shape`` ones (bit planes are int32 views of
  the reference's uint32; the decode cell's sampling key is a
  ``torch.Generator``, not compared);
* their specs on a placeholder (2, 2), (16, 16) and (2, 16, 16) mesh equal
  to the reference's ``param_spec`` / ``spec_for`` under
  ``test_torch_sharding.py``'s ``_Ctx`` of the same sizes, for every
  leaf; a moment's spec is resolved by its parameter's path, as the port
  resolves it (``sharding.train_state_shardings``: a norm scale's moment
  shards with its parameter, the reference's stays replicated);
* the float32-policy smoke prefill and decode cells' ``dot_flops`` equal to
  ``repro.roofline.hlo_stats.analyze_module`` of the JAX package's
  compiled cells on one CPU device (both run the same products);
* kernel records on ``meta`` equal to the (mode, m, n, k) of a real CPU
  run's ``qmm`` requests (a packed LM prefill and decode step) and to its
  ``qconv`` requests (the smoke CNN): one GeMM or one pack + one conv
  each; a mixed-device call raises;
* ``PlaceholderMesh`` collectives (count and bytes per kind and dtype) and
  train-state bytes equal to rank 0 of a real 4-rank gloo run
  (``tests/torch_dryrun_ranks.py``): a train step on (2, 2), a serving
  prefill on (1, 4);
* the dry-run's ``--single`` cell writes a PASS record with the
  reference's keys; a failing cell is recorded, not raised; a cached PASS
  record is reused without a worker.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.data.pipeline import global_batch_spec as jglobal_batch_spec
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.launch.specs import cell_artifacts as jcell_artifacts
from repro.models.kvcache import cache_logical_axes as jcache_logical_axes
from repro.parallel import sharding as jsharding
from repro.roofline.hlo_stats import analyze_module
from repro_torch import tree
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.paper_cnn import PAPER_CNN_SMOKE
from repro_torch.data import SyntheticLM, global_batch_spec
from repro_torch.kernels import _build, ops
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import PlaceholderMesh
from repro_torch.launch.specs import cell_artifacts
from repro_torch.models import model
from repro_torch.models.common import KV_CACHE_FORMATS, ShardLayout
from repro_torch.models.kvcache import cache_logical_axes, init_caches
from repro_torch.models.packing import pack_lm_params
from repro_torch.parallel import sharding
from repro_torch.roofline import op_stats
from repro_torch.train.train_step import init_train_state

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_dryrun_ranks as ranks  # noqa: E402

ARCH_NAMES = sorted(JARCHS)
KINDS = ("train", "prefill", "decode")
SIZES = [(2, 2), (16, 16), (2, 16, 16)]
META = torch.device("meta")
RULES = {"train": "TRAIN_RULES", "prefill": "PREFILL_RULES", "decode": "SERVE_RULES"}


def _shape(kind):
    return ShapeSpec("smoke", 16, 2, kind), JShapeSpec("smoke", 16, 2, kind)


def _jflat(t):
    return {jsharding._path_str(p): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}


def _tflat(t):
    return dict(tree.flatten_with_paths(t))


def _dtype(name):
    """The port's dtype of a reference leaf (bit planes: int32 views)."""
    return "int32" if name == "uint32" else name


def test_global_batch_spec_matches_reference():
    src = SyntheticLM(vocab_size=512, seq_len=24, global_batch=6, seed=0)
    got = global_batch_spec(src)
    want = jglobal_batch_spec(JSyntheticLM(vocab_size=512, seq_len=24, global_batch=6, seed=0))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.is_meta and tuple(v.shape) == want[k].shape
        assert str(v.dtype).replace("torch.", "") == want[k].dtype.name


@pytest.mark.parametrize("fmt", sorted(KV_CACHE_FORMATS))
def test_cache_logical_axes_match_reference(fmt):
    for arch in ARCH_NAMES:
        got = cache_logical_axes(get_smoke(arch, kv_cache_dtype=fmt))
        want = jcache_logical_axes(jget_smoke(arch, kv_cache_dtype=fmt))
        assert got == want, (arch, fmt)


@pytest.fixture(scope="module")
def cells():
    """(arch, kind) -> (the port's CellArtifacts, the reference's), no mesh."""
    out = {}
    for arch in ARCH_NAMES:
        for kind in KINDS:
            shape, jshape = _shape(kind)
            with jsharding.use_mesh(jmake_host_mesh(), getattr(jsharding, RULES[kind])):
                jart = jcell_artifacts(jget_smoke(arch), jshape)
            out[(arch, kind)] = (cell_artifacts(get_smoke(arch), shape), jart)
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cell_args_match_reference(cells, arch, kind):
    art, jart = cells[(arch, kind)]
    assert art.kind == jart.kind and art.donate == jart.donate
    n = 4 if kind == "decode" else len(jart.arg_shapes)     # the key: a Generator here
    assert len(art.args) == len(jart.arg_shapes)
    assert isinstance(art.args[-1], torch.Generator) or kind != "decode"
    for i in range(n):
        got, want = _tflat(art.args[i]), _jflat(jart.arg_shapes[i])
        assert sorted(got) == sorted(want), (i, set(got) ^ set(want))
        for path, leaf in want.items():
            t = got[path]
            assert t.is_meta and tuple(t.shape) == leaf.shape, (i, path)
            assert str(t.dtype).replace("torch.", "") == _dtype(leaf.dtype.name), (i, path)
        if isinstance(art.specs[i], dict):                 # a tree: a spec per leaf
            assert set(art.specs[i]) == set(got), i


class _Ctx:
    """Synthetic active-mesh stand-in (``test_torch_sharding.py``'s)."""

    def __init__(self, sizes, rules):
        names = ("pod", "data", "model") if len(sizes) == 3 else ("data", "model")
        self.axis_sizes = dict(zip(names, sizes))
        self.rules = rules
        self.mesh = None


def _whole_shapes(cfg, kind, tp):
    """{arg index: {path: whole shape}} of the port's cell on a mesh whose
    "model" axis is ``tp`` (the shapes the reference resolves specs on)."""
    lay = ShardLayout(tp=tp)
    b, s = 2, 16
    if kind == "train":
        from repro_torch.launch.specs import default_train_config
        state = init_train_state(None, cfg, lay, default_train_config(cfg), device=META)
        return {0: {p: tuple(t.shape) for p, t in _tflat(state).items()}}
    params = model.init_lm(torch.Generator(), cfg, lay, dtype=torch.bfloat16, device=META)
    if cfg.policy.for_class("attn_proj").is_lowbit:
        params = pack_lm_params(params, cfg)
    caches = init_caches(cfg, lay, b, s, device=META)
    return {0: {p: tuple(t.shape) for p, t in _tflat(params).items()},
            1: {f"{i}/{k}": tuple(e[k].shape) for i, e in enumerate(caches) for k in e}}


def _rule_path(path, params):
    """The path the port resolves a leaf's spec by: a moment's (``opt/m/X``,
    ``opt/v/X``; an int8 moment's ``X/q`` and ``X/scale``) is its parameter
    ``params/X``'s (``sharding.train_state_shardings``), so a norm scale's
    moment shards with it; the reference resolves the moment's own path,
    which leaves it replicated."""
    for pre in ("opt/m/", "opt/v/"):
        if path.startswith(pre):
            rest = path[len(pre):]
            return "params/" + (rest if "params/" + rest in params else rest.rsplit("/", 1)[0])
    return path


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cell_specs_match_reference(arch, kind):
    cfg = get_smoke(arch)
    shape, _ = _shape(kind)
    caxes = jcache_logical_axes(jget_smoke(arch))
    for sizes in SIZES:
        names = ("pod", "data", "model") if len(sizes) == 3 else ("data", "model")
        jctx = _Ctx(sizes, getattr(jsharding, RULES[kind]))
        with sharding.use_mesh(PlaceholderMesh(sizes, names), getattr(sharding, RULES[kind])):
            art = cell_artifacts(cfg, shape)
        whole = _whole_shapes(cfg, kind, sizes[-1])
        for path, shp in whole[0].items():
            spec = art.specs[0][path]
            rule = _rule_path(path, whole[0])
            jpath = tuple(jax.tree_util.DictKey(p) for p in rule.split("/"))
            want = tuple(jsharding.param_spec(jpath, jax.ShapeDtypeStruct(shp, jnp.float32),
                                              jctx))
            assert spec == want, (sizes, path)
        for path, shp in whole.get(1, {}).items():
            i, k = path.split("/")
            assert art.specs[1][path] == tuple(jsharding.spec_for(shp, caxes[int(i)][k], jctx))
        batch_arg = 1 if kind == "train" else 2
        specs = art.specs[batch_arg] if kind != "decode" else {
            "embeddings" if cfg.input_kind == "embeddings" else "tokens": art.specs[2]}
        seq = 1 if kind == "decode" else shape.seq_len
        for k, spec in specs.items():
            shp = (shape.global_batch, seq) + ((cfg.d_model,) if k == "embeddings" else ())
            axes = (("batch", None) if kind == "decode" else ("batch", "seq")) + \
                ((None,) if k == "embeddings" else ())
            assert spec == tuple(jsharding.spec_for(shp, axes, jctx)), (sizes, k)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_float_cell_dot_flops_match_hlo_stats(kind):
    """tinyllama smoke under the float32 policy: the products the port
    dispatches on ``meta`` and those of the reference's compiled module."""
    shape, jshape = _shape(kind)
    jcfg = jget_smoke("tinyllama-1.1b", quant_policy="f32")
    with jsharding.use_mesh(jmake_host_mesh(), getattr(jsharding, RULES[kind])):
        jart = jcell_artifacts(jcfg, jshape)
    plain = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                                   jart.arg_shapes)                     # one device
    txt = jax.jit(jart.step_fn).lower(*plain).compile().as_text()
    want = analyze_module(txt).dot_flops
    art = cell_artifacts(get_smoke("tinyllama-1.1b", quant_policy="f32"), shape)
    with op_stats.counting(art.args) as st, torch.no_grad():
        art.step_fn(*art.args)
    assert st.dot_flops == want, (st.dot_flops_by_dtype, want)


def _cpu_and_meta(run):
    """``run(device)`` on the CPU with ``ops.qmm`` / ``ops.qconv`` logged,
    then on ``meta`` with the kernel records read: -> (requests, records)."""
    requests = []
    real_qmm, real_qconv = ops.qmm, ops.qconv

    def qmm(x, qt, **kw):
        requests.append(("gemm", qt.mode.value, int(x.shape[0]), int(qt.out_features),
                         int(x.shape[1])))
        return real_qmm(x, qt, **kw)

    def qconv(x, qt, stride=1, padding="SAME", **kw):
        kh, kw_, cin, cout = qt.geometry
        oh, ow = -(-x.shape[1] // stride), -(-x.shape[2] // stride)
        requests.append(("conv", qt.mode.value, int(x.shape[0] * oh * ow), cout,
                         kh * kw_ * cin))
        return real_qconv(x, qt, stride=stride, padding=padding, **kw)

    ops.qmm, ops.qconv = qmm, qconv
    try:
        with torch.no_grad():
            run(torch.device("cpu"))
    finally:
        ops.qmm, ops.qconv = real_qmm, real_qconv
    _build.reset_records()
    with torch.no_grad():
        run(META)
    return requests, _build.records()


def _as_request(key, p):
    if key.startswith("lowbit_gemm_"):
        return ("gemm", key.split("_")[2], p["m"], p["n"], p["k"])
    if key.startswith("lowbit_conv_"):
        return ("conv", key.split("_")[2], p["b"] * p["oh"] * p["ow"], p["cout"],
                p["kh"] * p["kw"] * p["cin"])
    return None


@pytest.mark.parametrize("policy", ["tnn", "tbn", "bnn"])
def test_meta_records_match_cpu_lm_requests(policy):
    cfg = get_smoke("tinyllama-1.1b", quant_policy=policy)
    lay = ShardLayout()

    def run(dev):
        gen = torch.Generator().manual_seed(0)
        packed = pack_lm_params(model.init_lm(gen, cfg, lay, dtype=torch.bfloat16, device=dev),
                                cfg)
        caches = init_caches(cfg, lay, 2, 12, device=dev)
        _, caches = model.prefill(packed, {"tokens": torch.zeros((2, 8), dtype=torch.int64,
                                                                 device=dev)}, caches, cfg, lay)
        model.decode_step(packed, {"tokens": torch.zeros((2, 1), dtype=torch.int64,
                                                         device=dev)}, caches, 8, cfg, lay)

    requests, records = _cpu_and_meta(run)
    assert len(requests) == 2 * 7 * cfg.num_layers
    assert [_as_request(k, p) for k, p in records] == requests
    assert {k for k, _ in records} == {f"lowbit_gemm_{policy}_fused"}


def test_meta_records_match_cpu_cnn_requests():
    from repro_torch.cnn import PaperCNN

    def run(dev):
        net = PaperCNN(PAPER_CNN_SMOKE, device=dev)
        net(torch.zeros((2, 8, 8, 3), device=dev))

    requests, records = _cpu_and_meta(run)
    convs = [_as_request(k, p) for k, p in records if k.startswith("lowbit_conv_")]
    packs = [k for k, _ in records if k.startswith("conv_pack_")]
    assert convs == requests and len(requests) == 2
    assert packs == [f"conv_pack_{r[1]}" for r in requests]


def test_meta_and_cpu_operands_mixed_raise():
    a = torch.zeros((4, 2), dtype=torch.int32)
    from repro_torch.kernels import tnn_matmul
    with pytest.raises(ValueError, match="got a mix"):
        tnn_matmul.tnn_matmul_cuda(a, a, a.to(META), a.to(META))


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dryrun_ranks"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(os.path.dirname(HERE), "src"),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    res = mesh_mod.run_ranks([sys.executable, os.path.join(HERE, "torch_dryrun_ranks.py"), d],
                             4, timeout_s=240, env=env, log_dir=os.path.join(d, "logs"))
    assert all(r["returncode"] == 0 for r in res), mesh_mod.rank_logs(res)
    with open(os.path.join(d, "rank0.json")) as f:
        return json.load(f)


def test_placeholder_train_mesh_matches_gloo(gloo_ranks):
    cfg, tcfg, layout, _ = ranks.train_case()
    mesh = PlaceholderMesh(ranks.TRAIN_MESH, ("data", "model"))
    assert mesh.coords == gloo_ranks["coords"]
    with sharding.use_mesh(mesh, sharding.TRAIN_RULES):
        from repro_torch.data.pipeline import mesh_rows
        from repro_torch.train import make_train_step
        from repro_torch.train.train_step import state_shardings
        sh = state_shardings(cfg, layout, tcfg)
        state = init_train_state(torch.Generator(), cfg, layout, tcfg, device=META, shardings=sh)
        coord, shards = sharding.mesh_coord(mesh, sharding.batch_axes())
        rows = len(mesh_rows(ranks.BATCH, coord, shards))
        batch = {"tokens": torch.empty((rows, ranks.SEQ), dtype=torch.int32, device=META),
                 "labels": torch.empty((rows, ranks.SEQ), dtype=torch.int32, device=META),
                 "mask": torch.empty((rows, ranks.SEQ), dtype=torch.float32, device=META)}
        with op_stats.counting((state, batch)) as st:
            make_train_step(cfg, layout, tcfg)(state, batch)
    assert op_stats.tree_bytes(state) == gloo_ranks["state_bytes"]
    assert ranks.strip(mesh_mod.collectives()) == gloo_ranks["train_collectives"]
    assert st.collectives["all_gather_count"] == gloo_ranks["train_collectives"]["all_gather"]
    assert sum(st.collective_bytes_by_axis.values()) == st.collectives["total"]


def test_placeholder_serve_mesh_matches_gloo(gloo_ranks):
    from repro_torch.parallel import qmm_mesh

    cfg, layout = ranks.serve_case()
    mesh = PlaceholderMesh(ranks.SERVE_MESH, ("data", "model"))
    with sharding.use_mesh(mesh, sharding.RULESETS["serve_lowbit"]), torch.no_grad():
        packed = pack_lm_params(model.init_lm(torch.Generator(), cfg, layout,
                                              dtype=torch.bfloat16, device=META), cfg)
        caches = init_caches(cfg, layout, 2, ranks.PROMPT, device=META)
        with op_stats.counting((packed, caches)) as st:
            model.prefill(packed, {"tokens": torch.empty((2, ranks.PROMPT), dtype=torch.int64,
                                                         device=META)}, caches, cfg, layout)
    assert ranks.strip(qmm_mesh.collectives()) == gloo_ranks["serve_collectives"]
    reqs = gloo_ranks["serve_requests"]
    fused = sum(1 for k, _ in _build.records() if k.endswith("_fused"))
    i32 = sum(1 for k, _ in _build.records() if k.endswith("_i32"))
    assert fused + i32 == len(reqs) and i32 == gloo_ranks["serve_collectives"]["all_reduce"]
    assert st.kernels == {k: v for k, v in (("lowbit_gemm_tnn_fused", fused),
                                            ("lowbit_gemm_tnn_i32", i32)) if v}


REF_KEYS = {"arch", "shape", "mesh", "quant", "ruleset", "mesh_shape", "num_devices", "kind",
            "status", "memory", "cost", "static", "collectives", "collective_ops"}


def test_single_cell_writes_a_pass_record(tmp_path):
    rc = dryrun.main(["--single", "--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                      "--mesh", "pod", "--out", str(tmp_path)])
    assert rc == 0
    with open(tmp_path / "pod" / "tinyllama-1.1b__decode_32k.json") as f:
        rec = json.load(f)
    assert REF_KEYS <= set(rec) and rec["status"] == "PASS" and "trace_s" in rec
    assert rec["mesh_shape"] == [16, 16] and rec["num_devices"] == 256
    assert {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes"} <= \
        set(rec["memory"])
    assert {"flops", "bytes accessed"} <= set(rec["cost"])
    assert rec["cost"]["flops"] > 0 and rec["memory"]["argument_size_in_bytes"] > 0


def test_failing_cell_is_recorded_and_cached_pass_reused(tmp_path, monkeypatch):
    rec = dryrun.run_cell_here("tinyllama-1.1b", "decode_32k", "pod",
                               str(tmp_path / "bad.json"), quant="no_such_policy")
    assert rec["status"] == "FAIL" and "no_such_policy" in rec["error"]
    with open(tmp_path / "bad.json") as f:
        assert json.load(f)["status"] == "FAIL"
    path = tmp_path / "pod" / "tinyllama-1.1b__train_4k.json"
    path.parent.mkdir()
    path.write_text(json.dumps({"status": "PASS", "arch": "tinyllama-1.1b", "cached": True}))

    def no_worker(*a, **k):
        raise AssertionError("a worker started for a cached PASS record")

    monkeypatch.setattr(dryrun.subprocess, "run", no_worker)
    assert dryrun.run_cell("tinyllama-1.1b", "train_4k", "pod", str(tmp_path))["cached"]
