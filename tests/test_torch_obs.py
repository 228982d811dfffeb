"""The port's telemetry (``repro_torch.obs`` and the serving
instrumentation) on the CPU, against the JAX package's:

* the catalog equals the reference's less the three names the port does
  not register (the two jit retrace counters and the fallback counter);
* the registry, event log and snapshot formats are the reference's: the
  reference's ``python -m repro.obs --check`` accepts the port's
  snapshots (engine and process registries) and its events JSONL, and
  both render the same Prometheus text;
* ``annotate`` is a ``torch.profiler.record_function`` region while a
  profiler session records (one shared null context when obs is off or
  no session is open);
* ``qmm`` / ``qconv`` count their dispatches (obs-gated);
* an engine's counters reconcile exactly with its Results and
  ``page_stats()``, and equal the reference engine's on the same
  requests.
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_smoke as jget_smoke
from repro.models import model as jmodel
from repro.models.common import ShardLayout as JLayout
from repro.obs.__main__ import main as jobs_cli
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro_torch import interop, obs
from repro_torch.configs import get_smoke
from repro_torch.core.conv import pack_conv_filters
from repro_torch.kernels import ops
from repro_torch.kernels.modes import QuantMode
from repro_torch.models.common import ShardLayout
from repro_torch.obs.__main__ import main as obs_cli
from repro_torch.serving import Engine, Request, ServeConfig

NOT_PORTED = {"repro_qmm_traces_total", "repro_qconv_traces_total",
              "repro_kernel_fallback_total"}
ARCH = "tinyllama-1.1b"


@pytest.fixture()
def obs_on():
    was = obs.obs_enabled(), jobs.obs_enabled()
    obs.set_enabled(True)
    jobs.set_enabled(True)
    yield
    obs.set_enabled(was[0])
    jobs.set_enabled(was[1])


def test_catalog_is_the_reference_less_three():
    assert set(jobs.CATALOG) - set(obs.CATALOG) == NOT_PORTED
    assert set(obs.CATALOG) <= set(jobs.CATALOG)
    for name, spec in obs.CATALOG.items():
        assert (spec["type"], tuple(spec["labels"])) == \
            (jobs.CATALOG[name]["type"], tuple(jobs.CATALOG[name]["labels"]))
    assert (obs.SNAPSHOT_SCHEMA_VERSION, obs.SCHEMA_VERSION) == \
        (jobs.SNAPSHOT_SCHEMA_VERSION, jobs.SCHEMA_VERSION)
    assert (obs.ENV_OBS, obs.ENV_EVENTS, obs.ENV_SNAPSHOT) == \
        (jobs.ENV_OBS, jobs.ENV_EVENTS, jobs.ENV_SNAPSHOT)


def test_registry_semantics():
    reg = obs.MetricsRegistry(enabled=True)
    c = reg.counter("c_total", labels=("kind",))
    c.inc(kind="a")
    c.inc(2, kind="b")
    assert (c.value(kind="a"), c.total()) == (1, 3)
    with pytest.raises(ValueError, match="expected labels"):
        c.inc(other="x")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("c_total")
    g = reg.gauge("g")
    g.high_water(3)
    g.high_water(1)
    assert g.value() == 3
    h = reg.histogram("h", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    assert (h.count(), h.sum()) == (3, 5.55)
    assert h.snapshot()["series"][0]["value"]["buckets"] == {"0.1": 1, "1.0": 2}
    off = obs.MetricsRegistry(enabled=False)
    off.counter("x").inc()
    off.counter("y", always=True).inc()
    assert (off.counter("x").total(), off.counter("y").total()) == (0, 1)


def test_prometheus_text_equals_reference():
    reg = obs.MetricsRegistry(enabled=True)
    reg.counter("repro_engine_evictions_total", labels=("cause",)).inc(cause="done")
    reg.histogram("repro_engine_ttft_seconds").observe(0.3)
    reg.gauge("repro_engine_live_slots").set(2)
    snap = reg.snapshot()
    assert obs.to_prometheus(snap) == jobs.to_prometheus(snap)
    assert obs.check_snapshot(snap) == jobs.check_snapshot(snap) == []


def test_eventlog_envelope_and_off_switch(tmp_path, obs_on):
    log = obs.EventLog(path=str(tmp_path / "ev.jsonl"), engine="e9")
    log.emit("admit", uid=1)
    log.emit("finish", uid=1, status="ok")
    log.close()
    log.close()
    assert log.emit("late") is None
    lines = (tmp_path / "ev.jsonl").read_text().splitlines()
    assert [json.loads(ln)["seq"] for ln in lines] == [0, 1]
    assert all(obs.validate_line(ln) == jobs.validate_line(ln) == [] for ln in lines)
    obs.set_enabled(False)
    quiet = obs.EventLog(path=str(tmp_path / "off.jsonl"))
    assert quiet.emit("x") is None and not (tmp_path / "off.jsonl").exists()


def test_annotate_is_a_record_function_region(obs_on):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.annotate("decode_step") as region:
            pass
        assert isinstance(obs.annotate("x"), torch.profiler.record_function)
        assert region is not None
        obs.set_enabled(False)
        off = obs.annotate("x")
    assert "decode_step" in {e.name for e in prof.events()}
    assert isinstance(off, contextlib.nullcontext)
    obs.set_enabled(True)
    idle = obs.annotate("x")
    assert isinstance(idle, contextlib.nullcontext) and idle is off


def test_write_snapshot_if_configured(tmp_path, obs_on, monkeypatch):
    path = tmp_path / "snap.json"
    monkeypatch.setenv(obs.ENV_SNAPSHOT, str(path))
    assert obs.write_snapshot_if_configured() == str(path)
    assert jobs_cli(["--snapshot", str(path), "--check"]) == 0


def test_qmm_and_qconv_count_dispatches(obs_on):
    ctr = obs.get_registry().get("repro_qmm_dispatch_total")
    cctr = obs.get_registry().get("repro_qconv_dispatch_total")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    qt = ops.pack_weights(torch.from_numpy(rng.standard_normal((64, 8))
                                           .astype(np.float32)), QuantMode.BNN)
    before = ctr.value(mode="bnn", backend="torch", layout="gemm")
    ops.qmm(x, qt, backend="torch")
    ops.qmm(x, qt, backend="torch")
    assert ctr.value(mode="bnn", backend="torch", layout="gemm") == before + 2
    cq = pack_conv_filters(torch.ones((3, 3, 4, 8)), QuantMode.TNN)
    cbefore = cctr.value(mode="tnn", backend="cuda", layout="im2col_fused")
    ops.qconv(torch.ones((1, 5, 5, 4)), cq)
    assert cctr.value(mode="tnn", backend="cuda", layout="im2col_fused") == cbefore + 1
    obs.set_enabled(False)
    ops.qmm(x, qt, backend="torch")
    assert ctr.value(mode="bnn", backend="torch", layout="gemm") == before + 2


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_smoke(ARCH).with_(dtype=jnp.float32)
    params = jmodel.init_lm(jax.random.PRNGKey(1234), jcfg, JLayout(tp=1), dtype=jnp.float32)
    return params, interop.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                                device="cpu")


def _counters(m):
    return {"admissions": m.admissions.total(), "done": m.evictions.value(cause="done"),
            "ttft": m.ttft.count(), "itl": m.itl.count(),
            "prefill_tokens": m.prefill_tokens.total(),
            "decode_tokens": m.decode_tokens.total(), "steps": m.steps.total(),
            "kv_packed": m.kv_bytes.value(kind="packed"),
            "kv_dense": m.kv_bytes.value(kind="dense_equiv"),
            "high_water": m.page_high.value(entry="0")}


def test_engine_obs_reconciles_and_equals_reference(weights, obs_on, tmp_path):
    kw = dict(num_slots=4, max_len=64, page_size=8, prefill_chunk=8)
    jcfg = jget_smoke(ARCH).with_(dtype=jnp.float32, quant_policy="f32", kv_cache_dtype="tnn2")
    tcfg = get_smoke(ARCH).with_(dtype=torch.float32, quant_policy="f32",
                                 kv_cache_dtype="tnn2")
    je = JEngine(weights[0], jcfg, JLayout(tp=1), JServe(**kw))
    te = Engine(weights[1], tcfg, ShardLayout(tp=1), ServeConfig(**kw))
    te.obs.events.path = str(tmp_path / "ev.jsonl")
    rng = np.random.default_rng(7)
    lens = [8, 16, 8, 16, 8, 8, 16, 8, 16]
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n in lens]
    for eng, req in ((je, JRequest), (te, Request)):
        for uid, p in enumerate(prompts):
            eng.submit(req(uid=uid, prompt=p, max_new_tokens=5))
    results = te.run()
    je.run()
    m = te.obs
    n_tok = sum(len(r.tokens) for r in results.values())
    assert all(r.status == "ok" for r in results.values()) and len(results) == 9
    assert m.admissions.total() == 9 == m.evictions.value(cause="done")
    assert m.evictions.total() + m.queue_drops.total() == len(results)
    assert m.ttft.count() == 9 and m.itl.count() == n_tok - 9
    assert m.prefill_tokens.total() == sum(lens) and m.decode_tokens.total() == n_tok - 9
    assert m.queue_depth.value() == 0 and m.live_slots.value() == 0
    assert m._submit_ts == {} and m._last_tok_ts == {}
    assert m.page_high.value(entry="0") == te.page_stats()[0]["high_water"] > 0
    assert 0 < m.kv_bytes.value(kind="packed") < m.kv_bytes.value(kind="dense_equiv")
    assert _counters(m) == _counters(je.obs)
    # the reference's checker accepts the port's artifacts
    full = te.snapshot()
    for part in ("engine", "process"):
        path = tmp_path / f"{part}.json"
        path.write_text(json.dumps(full[part]))
        assert jobs_cli(["--snapshot", str(path), "--check"]) == 0
        assert obs_cli(["--snapshot", str(path), "--check"]) == 0
    te.close()
    te.close()
    assert m.events.closed and m.events.records(kind="engine_close")[-1]["in_flight"] == 0
    kinds = [json.loads(ln)["kind"] for ln in (tmp_path / "ev.jsonl").read_text().splitlines()]
    assert kinds[-1] == "engine_close" and kinds.count("finish") == 9
    assert jobs_cli(["--events", str(tmp_path / "ev.jsonl"), "--check"]) == 0
