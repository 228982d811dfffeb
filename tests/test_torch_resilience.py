"""The port's fault-injection plane (``repro_torch.resilience.faults``)
and its consumers against the JAX package's, on the CPU.

* the plan grammar parses to the same specs, and one plan with one seed
  fires at the same hits as the reference's (explicit hits, seeded rate
  streams, context matches, ``max_fires``);
* the kernel layer has no fallback chain: an armed ``kernel.compile``
  raises out of ``qmm`` / ``qconv``; in the engine ``run()`` quarantines
  the step, the in-flight requests finish as "error" with their pages
  released, and a fresh engine serves again once the plan is disarmed;
* ``pages.exhausted`` fires in the port's ``PageAllocator.alloc``;
* a chaos storm (the reference's STORM plan: page exhaustion, NaN
  logits, a device loss, a stalled step) over 16 requests on the paged
  smoke engine, fake clock: every uid's status and tokens equal the
  reference engine's under the same plan, the plan's report equal, the
  pages and the obs counters reconcile; preemption retries and
  ``close()`` under faults as the reference's.

The model is the f32 tinyllama smoke config on the reference's weights,
so greedy tokens are compared exactly.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import model as jmodel
from repro.models.common import ShardLayout as JLayout
from repro.resilience import faults as jfaults
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplerConfig as JSampler
from repro.serving import ServeConfig as JServe
from repro_torch import interop, obs
from repro_torch.configs import get_smoke
from repro_torch.core.conv import pack_conv_filters
from repro_torch.kernels import ops
from repro_torch.kernels.modes import QuantMode
from repro_torch.models import paged_kvcache as paged
from repro_torch.models.common import ShardLayout
from repro_torch.resilience import faults
from repro_torch.serving import Engine, Request, SamplerConfig, ServeConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "tinyllama-1.1b"
JL, TL = JLayout(tp=1), ShardLayout(tp=1)
DEFINITE = {"ok", "expired", "cancelled", "rejected", "numeric_error", "error"}
STORM = ("pages.exhausted@1+3+6;logits.nan@0;device.loss@2;step.stall@1;"
         "seed=1234;stall=0.002")
PLANS = ["kernel.compile@0?backend=cuda;pages.exhausted@1+4;logits.nan:0.05;seed=7;stall=0.002",
         "pages.exhausted:0.3;seed=11", "logits.nan@2+5:0.1?op=decode&path=chunked;seed=3",
         "device.loss:0.5;step.stall@0+1+2"]


@pytest.fixture(autouse=True)
def clean_plane():
    """Both planes disarmed around every test."""
    faults.disarm()
    jfaults.disarm()
    yield
    faults.disarm()
    jfaults.disarm()


@pytest.fixture()
def obs_on():
    was = obs.obs_enabled()
    obs.set_enabled(True)
    yield
    obs.set_enabled(was)


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_smoke(ARCH).with_(dtype=jnp.float32)
    params = jmodel.init_lm(jax.random.PRNGKey(1234), jcfg, JL, dtype=jnp.float32)
    return params, interop.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                                device="cpu")


class FakeClock:
    """+1 s per read: backoff windows and replays ignore wall time."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _engines(weights, kvd="tnn2", **over):
    kw = dict(num_slots=4, max_len=64, prefill_bucket=8, page_size=8, prefill_chunk=8)
    kw.update(over)
    jcfg = jget_smoke(ARCH).with_(dtype=jnp.float32, quant_policy="f32", kv_cache_dtype=kvd)
    tcfg = get_smoke(ARCH).with_(dtype=torch.float32, quant_policy="f32", kv_cache_dtype=kvd)
    je = JEngine(weights[0], jcfg, JL, JServe(sampler=JSampler(), **kw), clock=FakeClock())
    te = Engine(weights[1], tcfg, TL, ServeConfig(sampler=SamplerConfig(), **kw),
                clock=FakeClock())
    return je, te


def _prompts(n=16):
    rng = np.random.default_rng(7)
    vocab = get_smoke(ARCH).vocab_size
    return [rng.integers(0, vocab, ln) for ln in ([8, 16, 8, 16, 8, 8, 16, 8] * 2)[:n]]


def _outcome(results):
    return {u: (r.status, list(r.tokens)) for u, r in results.items()}


# ------------------------------------------------------------ fault plane

@pytest.mark.parametrize("text", PLANS)
def test_parse_plan_matches_reference(text):
    got, want = faults.parse_plan(text), jfaults.parse_plan(text)
    assert (got.seed, got.stall_s) == (want.seed, want.stall_s)
    assert {p: (s.hits, s.rate, s.match, s.max_fires) for p, s in got.specs.items()} == \
        {p: (s.hits, s.rate, s.match, s.max_fires) for p, s in want.specs.items()}
    assert sorted(faults.POINTS) == sorted(jfaults.POINTS)
    assert faults.ENV_FAULTS == jfaults.ENV_FAULTS


def _fire_sequence(plane, text, n=60):
    plan = plane.arm(plane.parse_plan(text))
    ctxs = [{"op": "decode", "path": "chunked"}, {"op": "prefill", "path": "chunked"},
            {"backend": "cuda"}, {"backend": "torch"}, {"want": 1}]
    fired = [plane.fire(point, **ctxs[i % len(ctxs)])
             for i in range(n) for point in sorted(plane.POINTS)]
    report = plan.report()
    plane.disarm()
    return fired, report


@pytest.mark.parametrize("text", PLANS)
def test_fire_sequence_matches_reference(text):
    got = _fire_sequence(faults, text)
    assert got == _fire_sequence(jfaults, text)
    assert any(got[0])


def test_max_fires_and_match_like_reference():
    for plane in (faults, jfaults):
        plan = plane.FaultPlan([plane.FaultSpec("logits.nan", rate=1.0, max_fires=2),
                                plane.FaultSpec("kernel.compile", hits=(0, 1),
                                                match={"backend": "cuda"})])
        plane.arm(plan)
        assert [plane.fire("logits.nan") for _ in range(4)] == [True, True, False, False]
        assert [plane.fire("kernel.compile", backend=b)
                for b in ("torch", "cuda", "cuda", "cuda")] == [False, True, True, False]
        assert plan.report() == {"logits.nan": {"hits": 4, "fires": 2},
                                 "kernel.compile": {"hits": 3, "fires": 2}}
        plane.disarm()


def test_disarmed_is_inert_and_unknown_points_rejected():
    assert faults.active() is None
    assert faults.fire("device.loss") is False
    faults.maybe_raise("kernel.compile", op="qmm")
    faults.maybe_stall()
    with pytest.raises(ValueError, match="unknown fault point"):
        faults.parse_plan("kernel.explode@0")
    with pytest.raises(ValueError, match="bad match clause"):
        faults.parse_plan("logits.nan@0?op")
    faults.arm(faults.parse_plan("logits.nan@0"))
    with pytest.raises(ValueError, match="unknown fault point"):
        faults.fire("not.a.point")


def test_env_arming_in_fresh_process():
    code = ("from repro_torch.resilience import faults; p = faults.active(); "
            "print(sorted(p.specs), p.seed)")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "REPRO_FAULTS": "device.loss@3;logits.nan:0.5;seed=9"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['device.loss', 'logits.nan'] 9"
    env["REPRO_FAULTS"] = "kernel.explode@1"
    out = subprocess.run([sys.executable, "-W", "always", "-c",
                          "from repro_torch.resilience import faults; print(faults.active())"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "None"
    assert "ignoring malformed REPRO_FAULTS" in out.stderr


# ------------------------------------------------------- no fallback chain

def _x_and_qt(seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((5, 96)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((96, 32)).astype(np.float32))
    return x, ops.pack_weights(w, QuantMode.TNN)


@pytest.mark.parametrize("backend", ["cuda", "torch", "dense"])
def test_injected_kernel_compile_raises_from_qmm(obs_on, backend):
    x, qt = _x_and_qt()
    want = ops.qmm(x, qt, backend=backend)
    faults.arm(faults.parse_plan(f"kernel.compile@0?backend={backend}"))
    with pytest.raises(faults.InjectedFault, match="kernel.compile"):
        ops.qmm(x, qt, backend=backend)
    assert torch.equal(ops.qmm(x, qt, backend=backend), want)   # hit 1: quiet
    assert not hasattr(ops, "fallback_decisions") and not hasattr(ops, "reset_fallbacks")
    assert "repro_kernel_fallback_total" not in obs.get_registry().names()


def test_injected_kernel_compile_raises_from_qconv():
    rng = np.random.default_rng(3)
    qt = pack_conv_filters(torch.from_numpy(rng.standard_normal((3, 3, 4, 8))
                                            .astype(np.float32)), QuantMode.TNN)
    x = torch.from_numpy(rng.standard_normal((2, 6, 6, 4)).astype(np.float32))
    want = ops.qconv(x, qt)
    faults.arm(faults.parse_plan("kernel.compile:1.0?op=qconv"))
    with pytest.raises(faults.InjectedFault):
        ops.qconv(x, qt)
    faults.disarm()
    assert torch.equal(ops.qconv(x, qt), want)


def test_pages_exhausted_fires_in_allocator():
    alloc = paged.PageAllocator(8)
    faults.arm(faults.parse_plan("pages.exhausted@1"))
    assert alloc.alloc(2) == [1, 2]
    with pytest.raises(paged.PagePoolExhausted, match="injected"):
        alloc.alloc(1)
    assert alloc.alloc(1) == [3] and alloc.n_used == 3
    assert faults.active().report() == {"pages.exhausted": {"hits": 3, "fires": 1}}


def test_engine_quarantines_injected_kernel_failure(weights, obs_on):
    """A kernel fault inside a step raises out of ``step()``; ``run()``
    finishes the in-flight requests as "error" (pages released), the
    queued ones still serve, and after disarming a fresh engine serves
    every request."""
    tcfg = get_smoke(ARCH).with_(dtype=torch.float32, quant_policy="tnn",
                                 kv_cache_dtype="tnn2")
    scfg = ServeConfig(num_slots=2, max_len=64, page_size=8, prefill_chunk=8,
                       pack_params=True)
    eng = Engine(weights[1], tcfg, TL, scfg, clock=FakeClock())
    eng.submit(Request(uid=0, prompt=_prompts(1)[0], max_new_tokens=3))
    faults.arm(faults.parse_plan("kernel.compile@0?op=qmm"))
    with pytest.raises(faults.InjectedFault):
        eng.step()
    eng.close()
    eng = Engine(weights[1], tcfg, TL, scfg, clock=FakeClock())
    for uid, p in enumerate(_prompts(4)):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=3))
    faults.arm(faults.parse_plan("kernel.compile@9?op=qmm"))
    res = eng.run()
    faults.disarm()
    assert [res[u].status for u in range(4)] == ["error", "error", "ok", "ok"]
    assert all(s["used"] == 0 for s in eng.page_stats())
    errs = eng.obs.events.records("step_error")
    assert len(errs) == 1 and errs[0]["error"] == "InjectedFault"
    fresh = Engine(weights[1], tcfg, TL, scfg, clock=FakeClock())
    for uid, p in enumerate(_prompts(2)):
        fresh.submit(Request(uid=uid, prompt=p, max_new_tokens=3))
    assert all(r.status == "ok" for r in fresh.run().values())


# ------------------------------------------------------------ chaos storm

def _storm(eng, plane, text, n=16, max_new=4):
    plane.arm(plane.parse_plan(text))
    req_cls = Request if plane is faults else JRequest
    for uid, p in enumerate(_prompts(n)):
        eng.submit(req_cls(uid=uid, prompt=p, max_new_tokens=max_new))
    res = _outcome(eng.run(max_steps=400))
    report = plane.active().report()
    plane.disarm()
    return res, report


def test_chaos_storm_matches_reference(weights, obs_on):
    je, te = _engines(weights)
    jres, jrep = _storm(je, jfaults, STORM)
    tres, trep = _storm(te, faults, STORM)
    assert tres == jres and trep == jrep
    assert sorted(tres) == list(range(16))
    assert {s for s, _ in tres.values()} <= DEFINITE
    assert len({p for p, c in trep.items() if c["fires"]}) >= 4
    assert not te._sched.queue and all(u == -1 for u in te.slot_uid)
    for s in te.page_stats():
        assert s["used"] == 0 and s["free"] == s["total"]
    snap = te.metrics()["metrics"]

    def total(name):
        return sum(s["value"] for s in snap.get(name, {"series": []})["series"])

    assert total("repro_engine_evictions_total") + total("repro_engine_queue_drops_total") == 16
    te.close()


def test_preemption_retries_match_reference(weights, obs_on):
    je, te = _engines(weights)
    jres, _ = _storm(je, jfaults, "pages.exhausted@1+2;seed=5", n=4, max_new=3)
    tres, _ = _storm(te, faults, "pages.exhausted@1+2;seed=5", n=4, max_new=3)
    assert tres == jres
    assert all(s == "ok" for s, _ in tres.values())
    pre = te.metrics()["metrics"]["repro_engine_preemptions_total"]["series"]
    assert sum(s["value"] for s in pre) == 2
    assert pre[0]["labels"] == {"cause": "page_exhausted"}


def test_close_idempotent_under_faults(weights, obs_on, tmp_path, monkeypatch):
    events = tmp_path / "events.jsonl"
    monkeypatch.setenv("REPRO_OBS_EVENTS", str(events))
    _, te = _engines(weights)
    tres, _ = _storm(te, faults, "device.loss@1;seed=2", n=4, max_new=3)
    assert "error" in {s for s, _ in tres.values()}
    for uid, p in enumerate(_prompts(2)):
        te.submit(Request(uid=100 + uid, prompt=p, max_new_tokens=3))
    te.step()
    assert any(u != -1 for u in te.slot_uid)
    te.close()
    te.close()
    for s in te.page_stats():
        assert s["used"] == 0 and s["free"] == s["total"]
    lines = [json.loads(ln) for ln in events.read_text().splitlines()]
    closes = [ln for ln in lines if ln.get("kind") == "engine_close"
              and ln.get("engine") == te.obs.engine_id]
    assert len(closes) == 1
    errs = [ln for ln in lines if ln.get("kind") == "step_error"]
    assert len(errs) == 1 and errs[0]["error"] == "InjectedFault"
