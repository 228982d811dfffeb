"""The port's autotuner (``repro_torch.tune``) on the CPU: tuning spaces,
the plan cache (JSON round trip, atomic write under a crash, corrupt
cache -> defaults, stale temp files, two processes writing one file),
``plan_for`` (the untuned choice on an empty cache, one memoized lookup
per problem), tuned dispatch through ``ops.qmm``, the
"on_first_use" policy, the offline CLI (a second run measures nothing
and leaves the file byte-identical) and the serving engine's build-time
sweep.

Against the JAX package: the plan key format, ``bucket_m``, the indexed
space's normalization and the problems ``collect_problems`` finds in a
packed tree (stacked and expert containers included) — all equal.
Tuned and untuned runs are compared exactly (``torch.equal``): a tile
choice cannot change an integer count.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.kernels.modes import QuantMode as JMode
from repro.models import model as jmodel
from repro.models.common import ShardLayout as JLayout
from repro.models.packing import pack_lm_params as jpack_lm_params
from repro.tune import cache as jcache
from repro.tune import space as jspace
from repro.tune import tuner as jtuner
from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.kernels import _matmul_common as mc
from repro_torch.kernels import ops, registry
from repro_torch.kernels._matmul_common import TileConfig, gemm_tile
from repro_torch.kernels.modes import QuantMode
from repro_torch.models.common import ShardLayout
from repro_torch.serving import Engine, Request, SamplerConfig, ServeConfig
from repro_torch.tune import cache as plan_cache
from repro_torch.tune import space, tuner
from repro_torch.tune.__main__ import main as tune_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = [QuantMode.BNN, QuantMode.TNN, QuantMode.TBN]
TL = ShardLayout(tp=1)


@pytest.fixture
def tcache(tmp_path):
    """An isolated plan cache per test; the prior path and the "off"
    policy are restored afterwards."""
    prev = os.environ.get(plan_cache.ENV_CACHE_PATH)
    cache = plan_cache.set_cache_path(str(tmp_path / "plans.json"))
    yield cache
    plan_cache.set_policy("off")
    plan_cache.set_cache_path(prev)


def _plan(mode=QuantMode.TNN, backend="torch", m=16, n=32, k=256,
          tiles=TileConfig(word_chunk=2), source="tuned"):
    return plan_cache.Plan(mode=mode, backend=backend, fused=True,
                           device_kind=plan_cache.device_kind("cpu"),
                           m_bucket=plan_cache.bucket_m(m), n=n, k=k, tiles=tiles,
                           source=source)


# ----------------------------------------------------------------- spaces

def test_cuda_space_default_first_then_tiles():
    cands = space.GEMM_SPACE.candidates(64, 256, 512, default=TileConfig(cta_tile=32))
    assert cands == [TileConfig(cta_tile=32), TileConfig(cta_tile=64), TileConfig(cta_tile=16)]
    cpu = space.GEMM_SPACE.candidates(8, 8, 32, default=TileConfig())
    assert cpu[0] == TileConfig() and len(cpu) == 4
    assert [c.cta_tile for c in space.DENSE_SPACE.candidates(
        8, 8, 32, default=TileConfig(cta_tile=32))] == [32, 64]


def test_torch_space_only_word_chunk_clamped():
    cands = space.TORCH_SPACE.candidates(16, 32, 96, default=TileConfig())
    # depth 96 = 3 words: the default 8 runs as 3, so 4..32 (clamped to
    # 3) dedupe against it and only 2 is new
    assert [c.word_chunk for c in cands] == [8, 2]
    assert all(c.cta_tile is None and c.seg_bits == 8 for c in cands)
    assert space.AFFINE_TORCH_SPACE.candidates(4, 4, 64, default=TileConfig()) == [TileConfig()]


def test_indexed_space_normalizes_like_reference():
    assert space.INDEXED_SPACE.seg_bits == jspace.INDEXED_SPACE.block_kw
    assert space.INDEXED_SPACE.word_chunk == jspace.INDEXED_SPACE.word_chunk
    for k in (32, 100, 256):
        for seg, wc in ((2, 8), (3, 64), (8, 1000), (1, 16)):
            got = space.INDEXED_SPACE.normalize(TileConfig(word_chunk=wc, seg_bits=seg), 8, 8, k)
            ref = jspace.INDEXED_SPACE.normalize(
                jspace.TileConfig(block_kw=seg, word_chunk=wc), 8, 128, k)
            assert (got.seg_bits, got.word_chunk) == (ref.block_kw, ref.word_chunk)


def test_space_validates_axes():
    with pytest.raises(ValueError, match="kind"):
        space.TuningSpace(kind="pallas")
    with pytest.raises(ValueError, match="cta_tile"):
        space.TuningSpace(kind="cuda")
    with pytest.raises(ValueError, match="word_chunk"):
        space.TuningSpace(kind="torch", word_chunk=(0,))


def test_registry_declares_spaces():
    for mode in MODES:
        for fused in (False, True):
            assert registry.lookup(mode, "cuda", fused=fused).tunable is space.GEMM_SPACE
            assert registry.lookup(mode, "torch", fused=fused).tunable is space.TORCH_SPACE
        assert registry.lookup(mode, "dense", fused=True).tunable is space.DENSE_SPACE
        assert registry.lookup(mode, "dense", fused=False).tunable is None
        for backend in ("cuda", "dense"):      # conv tiles are compiled in
            assert registry.lookup(mode, backend, fused=True,
                                   layout=registry.LAYOUT_IM2COL).tunable is None
    for mode in (QuantMode.INT8, QuantMode.INT4):
        assert registry.lookup(mode, "cuda", fused=True).tunable is space.AFFINE_SPACE
        assert registry.lookup(mode, "torch", fused=True).tunable is space.AFFINE_TORCH_SPACE


def test_cta_tile_takes_a_compiled_tile_or_the_plan_default(monkeypatch):
    monkeypatch.setattr(mc, "sm_count", lambda device: 132)
    assert mc.cta_tile(None, 4, 2048, 0) == gemm_tile(4, 2048, 132)
    assert mc.cta_tile(32, 4, 2048, 0) == 32
    assert mc.cta_tile(None, 4, 2048, 0, mc.DENSE_TILES) == gemm_tile(4, 2048, 132,
                                                                      mc.DENSE_TILES)
    with pytest.raises(ValueError, match="not compiled"):
        mc.cta_tile(48, 4, 2048, 0)
    with pytest.raises(ValueError, match="not compiled"):
        mc.cta_tile(16, 4, 2048, 0, mc.AFFINE_TILES)


# ------------------------------------------------------------ plan cache

def test_plan_key_and_bucket_match_reference():
    for m in (1, 4, 8, 9, 128, 129, 512):
        assert plan_cache.bucket_m(m) == jcache.bucket_m(m)
    for layout, geom in (("gemm", None), ("im2col_fused", "3x3s1same")):
        assert plan_cache.plan_key(QuantMode.TNN, "cuda", True, "dev", 16, 32, 96,
                                   layout=layout, geom=geom) == \
            jcache.plan_key(JMode.TNN, "cuda", True, "dev", 16, 32, 96, layout=layout,
                            geom=geom)


def test_plan_json_roundtrip(tcache):
    for tiles in (TileConfig(word_chunk=2), TileConfig(cta_tile=64),
                  TileConfig(word_chunk=16, seg_bits=4)):
        p = _plan(tiles=tiles)
        assert plan_cache.Plan.from_json(p.to_json()) == p
        assert TileConfig.from_json(tiles.to_json()) == tiles
        tcache.put(p)
        tcache.save()
        assert plan_cache.PlanCache(tcache.path).load().get(p.key) == p


def test_atomic_write_crash_leaves_old_cache_intact(tcache, monkeypatch):
    tcache.put(_plan(n=32))
    tcache.save()
    before = open(tcache.path, "rb").read()
    tcache.put(_plan(n=64))

    def boom(*a, **k):
        raise OSError("simulated crash")

    monkeypatch.setattr(plan_cache.os, "replace", boom)
    with pytest.raises(OSError, match="simulated crash"):
        tcache.save()
    monkeypatch.undo()
    assert open(tcache.path, "rb").read() == before
    assert not [f for f in os.listdir(os.path.dirname(tcache.path)) if f.endswith(".tmp")]


def test_corrupt_cache_falls_back_to_default(tcache):
    with open(tcache.path, "w") as f:
        f.write("{not json")
    with pytest.warns(UserWarning, match="corrupt tune plan cache"):
        plan = plan_cache.plan_for(QuantMode.TNN, "torch", fused=True, m=8, n=32, k=96,
                                   device="cpu")
    assert plan.source == "default" and plan.tiles == TileConfig()


def test_stale_tmp_files_cleaned_on_load(tmp_path):
    stale, fresh = tmp_path / ".tune_plans.dead.tmp", tmp_path / ".tune_plans.live.tmp"
    stale.write_text("x")
    fresh.write_text("x")
    old = os.path.getmtime(stale) - 3600
    os.utime(stale, (old, old))
    plan_cache.PlanCache(str(tmp_path / "plans.json")).load()
    assert not stale.exists() and fresh.exists()


_WRITER = """
import sys
from repro_torch.kernels.modes import QuantMode
from repro_torch.tune import cache
c = cache.PlanCache(sys.argv[1])
c.load()
c.put(cache.default_plan(QuantMode.TNN, "torch", True, 8, int(sys.argv[2]), 128,
                         device="cpu"))
c.save()
"""


def test_two_process_writers_union_their_plans(tmp_path):
    path = str(tmp_path / "plans.json")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    procs = [subprocess.Popen([sys.executable, "-c", _WRITER, path, n], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for n in ("64", "96")]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()
    plans = plan_cache.PlanCache(path).load().plans()
    assert sorted(p.n for p in plans.values()) == [64, 96]


def test_plan_for_on_empty_cache_is_gemm_tiles_choice(tcache, monkeypatch):
    """On the CPU the CUDA cells' default leaves the tile to the launch
    (None); on a card it is gemm_tile's tile for the shape."""
    cpu = plan_cache.plan_for(QuantMode.TNN, "cuda", fused=True, m=4, n=2048, k=2048,
                              device="cpu")
    assert cpu.source == "default" and cpu.tiles == TileConfig(cta_tile=None)
    monkeypatch.setattr(plan_cache, "sm_count", lambda idx: 132)
    monkeypatch.setattr(plan_cache, "device_kind", lambda device=None: "nvidia-h100")
    card = torch.device("cuda", 0)
    for backend, tiles in (("cuda", mc.GEMM_TILES), ("dense", mc.DENSE_TILES)):
        for m, n in ((4, 2048), (512, 5632), (128, 256)):
            plan = plan_cache.plan_for(QuantMode.TNN, backend, fused=True, m=m, n=n, k=2048,
                                       device=card)
            assert plan.tiles == TileConfig(cta_tile=gemm_tile(m, n, 132, tiles))
    plan = plan_cache.plan_for(QuantMode.INT8, "cuda", fused=True, m=256, n=512, k=64,
                               device=card)
    assert plan.tiles.cta_tile == gemm_tile(256, 512, 132, mc.AFFINE_TILES)
    assert plan_cache.plan_for(QuantMode.TNN, "torch", fused=True, m=4, n=8, k=64,
                               device=card).tiles == TileConfig()


def test_plan_for_memoized_until_the_cache_changes(tcache):
    kw = dict(fused=True, m=16, n=32, k=256, device="cpu")
    first = plan_cache.plan_for(QuantMode.TNN, "torch", **kw)
    assert plan_cache.plan_for(QuantMode.TNN, "torch", **kw) is first
    assert first.source == "default"
    tcache.put(_plan())
    hit = plan_cache.plan_for(QuantMode.TNN, "torch", **kw)
    assert hit.source == "tuned" and hit.tiles == TileConfig(word_chunk=2)


def test_plan_for_contains_cache_failures(tcache):
    from repro_torch.resilience import faults

    faults.arm(faults.parse_plan("plan_cache.io@0"))
    try:
        with pytest.warns(UserWarning, match="corrupt tune plan cache"):
            plan = plan_cache.plan_for(QuantMode.TNN, "torch", fused=True, m=8, n=32,
                                       k=96, device="cpu")
        assert plan.source == "default"
        faults.arm(faults.parse_plan("plan_cache.io@0?op=save"))
        with pytest.warns(UserWarning, match="contained"):
            plan, measured = tuner.ensure_plan(QuantMode.TNN, "torch", m=8, n=32, k=96,
                                               reps=1, warmup=1, device="cpu")
        assert measured and plan.source == "tuned"
    finally:
        faults.disarm()


# ------------------------------------------------------ tuned dispatch

def test_qmm_dispatches_the_plans_tiles(tcache, monkeypatch):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((5, 96)).astype(np.float32))
    qt = ops.pack_weights(torch.from_numpy(rng.standard_normal((96, 32))
                                           .astype(np.float32)), QuantMode.TNN)
    want = ops.qmm(x, qt, backend="torch")
    spec = registry.lookup(QuantMode.TNN, "torch", fused=True)
    seen = []

    def recording(*a, tiles=None, **k):
        seen.append(tiles)
        return spec.fn(*a, tiles=tiles, **k)

    monkeypatch.setitem(registry._REGISTRY, spec.key, spec.__class__(
        **{**spec.__dict__, "fn": recording}))
    tcache.put(_plan(m=5, n=32, k=96, tiles=TileConfig(word_chunk=2)))
    got = ops.qmm(x, qt, backend="torch")
    assert seen == [TileConfig(word_chunk=2)]
    assert torch.equal(got, want)


def test_tuner_deterministic_and_never_worse_than_default(tcache, monkeypatch):
    times = iter([3.0, 1.0, 1.0, 2.0, 5.0])
    monkeypatch.setattr(tuner, "measure", lambda call, **kw: (call(), next(times))[1])
    plan, report = tuner.tune_one(QuantMode.TNN, "torch", m=8, n=32, k=256, device="cpu")
    assert report["best_index"] == 1 and report["default_s"] == 3.0
    assert plan.tiles == TileConfig(word_chunk=2) and plan.source == "tuned"
    conv = tuner.ConvProblem(batch=1, height=4, width=4, cin=8, cout=4, kernel_h=3,
                             kernel_w=3)
    plan, report = tuner.tune_one(QuantMode.TNN, "cuda", conv=conv, device="cpu")
    assert report["untunable"] and plan.source == "default"
    assert plan.geom == "3x3s1same" and plan.layout == "im2col_fused"
    # an explicit space measures the conv cell on seeded operands, over
    # its positional words (3 x 3 x 1 = 9): word_chunk 8, 2, 4, 9
    monkeypatch.undo()
    plan, report = tuner.tune_one(QuantMode.TNN, "cuda", conv=conv, device="cpu",
                                  space=space.TORCH_SPACE, reps=1)
    assert plan.source == "tuned"
    assert [c["tiles"]["word_chunk"] for c in report["candidates"]] == [8, 2, 4, 9]


def test_on_first_use_policy_tunes_then_serves_from_cache(tcache):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((6, 64)).astype(np.float32))
    qt = ops.pack_weights(torch.from_numpy(rng.standard_normal((64, 16))
                                           .astype(np.float32)), QuantMode.BNN)
    want = ops.qmm(x, qt, backend="torch")
    plan_cache.set_policy("on_first_use")
    got = ops.qmm(x, qt, backend="torch")
    assert len(tcache) == 1
    key = next(iter(tcache.plans()))
    assert key == "bnn/torch/fused/cpu/m8/n16/k64"
    bytes1 = open(tcache.path, "rb").read()
    assert torch.equal(ops.qmm(x, qt, backend="torch"), got)
    assert open(tcache.path, "rb").read() == bytes1 and len(tcache) == 1
    assert torch.equal(got, want)


def test_cli_second_run_is_pure_byte_identical_cache_hit(tcache, capsys):
    argv = ["--shapes", "8x32x96", "--modes", "tnn", "bnn", "--backends", "cuda", "torch",
            "--reps", "1", "--warmup", "1", "--cache", tcache.path, "--device", "cpu"]
    assert tune_cli(argv) == 0
    out1 = capsys.readouterr().out
    assert "measured=4" in out1 and "cached=0" in out1
    bytes1 = open(tcache.path, "rb").read()
    assert tune_cli(argv) == 0
    out2 = capsys.readouterr().out
    assert "measured=0" in out2 and "cached=4" in out2
    assert open(tcache.path, "rb").read() == bytes1


def test_cli_rejects_bad_shape():
    with pytest.raises(SystemExit):
        tune_cli(["--shapes", "16x0x8", "--device", "cpu"])


# --------------------------------------------------------------- problems

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b"])
def test_collect_problems_matches_reference(arch):
    """Stacked period containers and (P, E) expert containers count as
    their per-period problem, as in the reference."""
    jcfg = jget_smoke(arch).with_(dtype=jnp.float32, quant_policy="tnn")
    params = jpack_lm_params(jmodel.init_lm(jax.random.PRNGKey(0), jcfg, JLayout(tp=1),
                                            dtype=jnp.float32), jcfg)
    tparams = interop.lm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    got = [(m.value, k, n, g) for m, k, n, g in tuner.collect_problems(tparams)]
    want = [(m.value, k, n, g) for m, k, n, g in jtuner.collect_problems(params)]
    assert sorted(got) == sorted(want) and got


# ----------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def tnn_smoke():
    cfg = get_smoke("tinyllama-1.1b").with_(dtype=torch.float32, quant_policy="tnn")
    from repro_torch.models import model as model_mod
    return cfg, model_mod.init_lm(torch.Generator().manual_seed(0), cfg, TL, device="cpu")


def _serve(cfg, params, autotune, **kw):
    scfg = ServeConfig(num_slots=2, max_len=16, prefill_bucket=8, pack_params=True,
                       autotune=autotune, sampler=SamplerConfig(), trace_logits=True, **kw)
    eng = Engine(params, cfg, TL, scfg)
    rng = np.random.default_rng(2)
    for uid in range(3):
        eng.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size, 5 + 3 * uid),
                           max_new_tokens=4))
    res = eng.run()
    eng.close()
    return {u: r.tokens for u, r in res.items()}, eng


def test_engine_offline_autotune_persists_plans_and_tokens_equal_off(tcache, tnn_smoke):
    cfg, params = tnn_smoke
    off, off_eng = _serve(cfg, params, "off")
    assert len(tcache) == 0
    tuned, eng = _serve(cfg, params, "offline")
    plans = plan_cache.PlanCache(tcache.path).load().plans()
    problems = tuner.collect_problems(eng.params)
    # decode m = 2 -> bucket 8, prefill buckets 8 and 16
    assert {(p.k, p.n, p.m_bucket) for p in plans.values()} == \
        {(k, n, mb) for _, k, n, _ in problems for mb in (8, 16)}
    assert all(p.fused and p.source == "tuned" and p.backend == "cuda" for p in plans.values())
    assert tuned == off
    for uid in off:
        for a, b in zip(eng.logit_trace[uid], off_eng.logit_trace[uid]):
            np.testing.assert_array_equal(a, b)


def test_engine_on_first_use_tunes_then_serves_and_close_disarms(tcache, tnn_smoke):
    cfg, params = tnn_smoke
    tokens, _ = _serve(cfg, params, "on_first_use")
    n_plans = len(plan_cache.PlanCache(tcache.path).load())
    assert n_plans > 0 and plan_cache.get_policy() == "off"        # close() disarmed
    bytes1 = open(tcache.path, "rb").read()
    again, _ = _serve(cfg, params, "on_first_use")
    assert again == tokens and open(tcache.path, "rb").read() == bytes1
    plan_cache.set_policy("on_first_use")
    _serve(cfg, params, "off")                       # an "off" engine disarms it
    assert plan_cache.get_policy() == "off"
    with Engine(params, cfg, TL, ServeConfig(num_slots=2, max_len=16, prefill_bucket=8,
                                             pack_params=True, autotune="on_first_use")):
        assert plan_cache.get_policy() == "on_first_use"
    assert plan_cache.get_policy() == "off"


def test_engine_rejects_unknown_autotune_value(tnn_smoke):
    cfg, params = tnn_smoke
    with pytest.raises(ValueError, match="autotune"):
        Engine(params, cfg, TL, ServeConfig(autotune="always"))
