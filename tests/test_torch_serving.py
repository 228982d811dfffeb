"""The port's serving engine (``repro_torch.serving``) against the JAX
package's, on the CPU, on the tinyllama smoke config: both engines get
the same weights (the reference's ``init_lm`` tree, packed by each side
or loaded packed through ``interop.lm_params_from_numpy``), the same
requests (numpy seeds) and the same ``ServeConfig``.

Bounds:

* f32 policy, greedy, dense and paged (``tnn2``) caches: every uid's
  tokens and status equal;
* ``tnn`` packed (``pack_params=True``): every logit trace row within
  ``test_torch_lm.assert_rows_close``'s bound (5e-4, the reference's
  packed-serving bound, with its rounding-step allowance), tokens equal;
* the scheduler's state machine on a fake clock (deadline, cancel,
  backpressure, overlong prompts, several slots admitted in one tick,
  ``close()`` after an eviction): the ``Result`` statuses equal the
  reference engine's on the same scripted timeline, and the page pool
  balances to zero;
* the sampler: greedy ties to the first index, padded vocabulary
  columns never win, top-k sampling stays in the top k.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import model as jmodel
from repro.models.common import ShardLayout as JLayout
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplerConfig as JSampler
from repro.serving import ServeConfig as JServe
from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.models.common import ShardLayout
from repro_torch.serving import (Engine, Request, SamplerConfig, ServeConfig, sample)
from test_torch_lm import assert_rows_close

ARCH = "tinyllama-1.1b"
PACKED_TOL = 5e-4
JL, TL = JLayout(tp=1), ShardLayout(tp=1)
BASE = dict(num_slots=4, max_len=64, prefill_bucket=8, page_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def weights():
    """Reference f32 smoke weights and the port's copy of them."""
    jcfg = jget_smoke(ARCH).with_(dtype=jnp.float32)
    params = jmodel.init_lm(jax.random.PRNGKey(1234), jcfg, JL, dtype=jnp.float32)
    return params, interop.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                                device="cpu")


def _cfgs(policy="f32", kvd="bf16"):
    return (jget_smoke(ARCH).with_(dtype=jnp.float32, quant_policy=policy, kv_cache_dtype=kvd),
            get_smoke(ARCH).with_(dtype=torch.float32, quant_policy=policy, kv_cache_dtype=kvd))


def _engines(weights, policy="f32", kvd="bf16", clock=None, **over):
    """(reference engine, port engine) on the same weights and config;
    ``clock`` a factory of fake clocks, one per engine."""
    jcfg, tcfg = _cfgs(policy, kvd)
    kw = {**BASE, **over}
    je = JEngine(weights[0], jcfg, JL, JServe(sampler=JSampler(), **kw),
                 clock=clock and clock())
    te = Engine(weights[1], tcfg, TL, ServeConfig(sampler=SamplerConfig(), **kw),
                clock=clock and clock())
    return je, te


def _prompts(n, lengths=(8, 16, 5, 12, 8, 3, 16, 7), seed=7):
    rng = np.random.default_rng(seed)
    vocab = get_smoke(ARCH).vocab_size
    return [rng.integers(0, vocab, lengths[i % len(lengths)]) for i in range(n)]


def _both(je, te, fn):
    """Run ``fn(engine, Request class)`` on both engines."""
    return fn(je, JRequest), fn(te, Request)


def _outcome(results):
    return {u: (r.status, list(r.tokens)) for u, r in results.items()}


def _submit(prompts, max_new=5):
    def fn(eng, req_cls):
        for uid, p in enumerate(prompts):
            eng.submit(req_cls(uid=uid, prompt=p, max_new_tokens=max_new))
        return _outcome(eng.run())
    return fn


@pytest.mark.parametrize("kvd", ["bf16", "tnn2"])
def test_f32_greedy_tokens_equal_reference(weights, kvd):
    je, te = _engines(weights, "f32", kvd)
    jr, tr = _both(je, te, _submit(_prompts(8)))
    assert tr == jr
    assert all(s == "ok" for s, _ in tr.values())
    assert te.page_stats() == je.page_stats()
    for s in te.page_stats():
        assert s["used"] == 0 and s["free"] == s["total"]


@pytest.mark.parametrize("kvd", ["bf16", "tnn2"])
def test_tnn_packed_logit_traces_within_bound(weights, kvd):
    je, te = _engines(weights, "tnn", kvd, pack_params=True, trace_logits=True)
    jr, tr = _both(je, te, _submit(_prompts(6)))
    assert tr == jr
    for uid in jr:
        got = np.stack(te.logit_trace[uid])
        want = np.stack([np.asarray(r, np.float64) for r in je.logit_trace[uid]])
        assert_rows_close(got, want, PACKED_TOL, f"uid {uid}")
    for s in te.page_stats():
        assert s["used"] == 0


def test_bucket_prompts_of_every_bucket(weights):
    """Prompts landing in the 8-, 16- and 32-token buckets (left pad
    poisoned), and one longer than the last bucket (rejected)."""
    lengths = (3, 8, 9, 16, 17, 30, 70)
    je, te = _engines(weights, "f32", "bf16")
    jr, tr = _both(je, te, _submit(_prompts(7, lengths), max_new=4))
    assert tr == jr
    assert tr[6][0] == "rejected" and tr[0][0] == "ok"


class FakeClock:
    """+1 s per read, so deadlines and backoff windows are scripted."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _deadline_script(eng, req_cls):
    """The reference's deadline / cancel timeline (its
    ``test_deadline_and_cancel_reclaim_pages``), on a set clock."""
    now = [0.0]
    eng._sched.clock = lambda: now[0]
    p = _prompts(6, (6,), seed=5)
    eng.submit(req_cls(uid=0, prompt=p[0], max_new_tokens=20))
    eng.submit(req_cls(uid=1, prompt=p[1], max_new_tokens=20, deadline=5.0))
    eng.submit(req_cls(uid=2, prompt=p[2], max_new_tokens=4, deadline=-1.0))
    r3 = req_cls(uid=3, prompt=p[3], max_new_tokens=4)
    eng.submit(r3)
    r3.cancel()
    trail = []
    for _ in range(4):
        eng.step()
        trail.append(sorted(u for u in eng.slot_uid if u != -1))
    now[0] = 6.0
    eng.step()
    r4 = req_cls(uid=4, prompt=p[4], max_new_tokens=20)
    eng.submit(r4)
    eng.step()
    trail.append(sorted(u for u in eng.slot_uid if u != -1))
    r4.cancel()
    while eng.step():
        pass
    return _outcome(eng.results), trail


@pytest.mark.parametrize("kvd", ["bf16", "tnn2"])
def test_deadline_and_cancel_timeline_matches_reference(weights, kvd):
    je, te = _engines(weights, "f32", kvd)
    (jr, jtrail), (tr, ttrail) = _both(je, te, _deadline_script)
    assert tr == jr and ttrail == jtrail
    assert {u: s for u, (s, _) in tr.items()} == {
        0: "ok", 1: "expired", 2: "expired", 3: "cancelled", 4: "cancelled"}
    assert tr[2][1] == [] and tr[3][1] == [] and 1 <= len(tr[1][1]) < 21
    for s in te.page_stats():
        assert s["used"] == 0 and s["free"] == s["total"]


def test_backpressure_rejects_past_queue_bound(weights):
    je, te = _engines(weights, "f32", "tnn2", num_slots=2, max_queue=3)

    def script(eng, req_cls):
        for uid, p in enumerate(_prompts(6)):
            eng.submit(req_cls(uid=uid, prompt=p, max_new_tokens=2))
        early = sorted(u for u, r in eng.results.items() if r.status == "rejected")
        return early, _outcome(eng.run())

    (jearly, jr), (tearly, tr) = _both(je, te, script)
    assert tearly == jearly == [3, 4, 5]
    assert tr == jr
    assert [tr[u][0] for u in range(3)] == ["ok"] * 3


@pytest.mark.parametrize("kvd,length", [("bf16", 65), ("tnn2", 64)])
def test_overlong_prompt_rejected(weights, kvd, length):
    """Past the last bucket (dense), or no room to decode (paged)."""
    je, te = _engines(weights, "f32", kvd)

    def script(eng, req_cls):
        eng.submit(req_cls(uid=0, prompt=np.arange(length) % 7, max_new_tokens=2))
        more = eng.step()
        return more, _outcome(eng.results)

    jr, tr = _both(je, te, script)
    assert tr == jr == (False, {0: ("rejected", [])})


def test_multi_slot_admission_single_tick(weights):
    je, te = _engines(weights, "f32", "tnn2")

    def script(eng, req_cls):
        for uid, p in enumerate(_prompts(4, (16,), seed=11)):
            eng.submit(req_cls(uid=uid, prompt=p, max_new_tokens=4))
        eng.step()
        admitted = list(eng.slot_uid)
        steps = 1
        while eng.step() and steps < 50:
            steps += 1
        return admitted, steps, _outcome(eng.results)

    jr, tr = _both(je, te, script)
    assert tr == jr
    admitted, steps, res = tr
    assert admitted == [0, 1, 2, 3] and steps <= 2 + 4 + 2
    assert all(len(t) == 5 for _, t in res.values())
    for s in te.page_stats():
        assert s["used"] == 0 and s["free"] == s["total"]


def test_close_idempotent_after_inflight_eviction(weights):
    je, te = _engines(weights, "f32", "tnn2")

    def script(eng, req_cls):
        reqs = [req_cls(uid=u, prompt=p, max_new_tokens=10)
                for u, p in enumerate(_prompts(2, (6,), seed=13))]
        for r in reqs:
            eng.submit(r)
        eng.step()
        reqs[0].cancel()
        eng.step()
        out = _outcome(eng.results)
        eng.close()
        eng.close()
        return out, [s["used"] for s in eng.page_stats()]

    jr, tr = _both(je, te, script)
    assert tr == jr
    assert tr[0][0][0] == "cancelled" and tr[1] == [0]
    # the context-manager form closes an engine with work in flight
    with _engines(weights, "f32", "tnn2")[1] as eng2:
        eng2.submit(Request(uid=9, prompt=_prompts(1)[0], max_new_tokens=3))
        eng2.step()
    assert eng2._closed and all(s["used"] == 0 for s in eng2.page_stats())


def test_step_api_equals_run(weights):
    _, te = _engines(weights, "f32", "bf16")
    te.submit(Request(uid=0, prompt=np.asarray([3, 1, 4]), max_new_tokens=3))
    steps = 0
    while te.step() and steps < 20:
        steps += 1
    _, te2 = _engines(weights, "f32", "bf16")
    te2.submit(Request(uid=0, prompt=np.asarray([3, 1, 4]), max_new_tokens=3))
    assert _outcome(te.results) == _outcome(te2.run())
    assert te.results[0].status == "ok" and len(te.results[0].tokens) == 4


def test_engine_keeps_its_device_and_kv_bytes_match_reference(weights):
    je, te = _engines(weights, "f32", "tnn2")
    assert te.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for c in te.caches for t in c.values())

    def gauges(snap):
        series = snap["metrics"]["repro_engine_kv_cache_bytes"]["series"]
        return {s["labels"]["kind"]: s["value"] for s in series}

    g = gauges(te.metrics())
    if g:                                # obs on: the gauges are recorded
        assert g == gauges(je.metrics())
        assert g["dense_equiv"] > g["packed"]


def test_mesh_watchdog_and_rebuild_not_ported(weights):
    """The mesh engine is ported (tests/test_torch_mesh.py serves on 4
    ranks); what remains here are its guards: a mesh must be a
    ``launch.mesh.Mesh`` with a known ruleset, and a single-device engine
    has no watchdog or rebuild (the reference's RuntimeErrors)."""
    _, tcfg = _cfgs()
    with pytest.raises(TypeError, match="Mesh"):
        Engine(weights[1], tcfg, TL, ServeConfig(mesh=object()))
    with pytest.raises(ValueError, match="mesh_rules"):
        Engine(weights[1], tcfg, TL, ServeConfig(mesh=object(), mesh_rules="bogus"))
    _, te = _engines(weights)
    for call in (te.make_watchdog, lambda: te.rebuild_after_loss([0])):
        with pytest.raises(RuntimeError, match="mesh"):
            call()


def test_sampler_greedy_ties_and_vocab_mask():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [5.0, 5.0, 1.0, 9.0]])
    cfg = SamplerConfig()
    assert sample(logits, None, cfg).tolist() == [1, 3]
    assert np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)).tolist() == [1, 3]
    masked = dataclasses.replace(cfg, vocab_size=3)
    assert sample(logits, None, masked).tolist() == [1, 0]


def test_sampler_top_k_stays_in_top_k():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((64, 50)).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    cfg = SamplerConfig(temperature=0.7, top_k=5, vocab_size=40)
    toks = sample(logits, gen, cfg)
    top = logits[:, :40].topk(5, dim=-1).indices
    assert all(int(t) in top[i].tolist() for i, t in enumerate(toks))
    again = sample(logits, torch.Generator().manual_seed(3), cfg)
    assert torch.equal(toks, again)                   # same generator state, same draw
