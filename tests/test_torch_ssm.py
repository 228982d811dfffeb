"""The port's Mamba2 / SSD mixer (``repro_torch.models.ssm``) against the
JAX package's (``repro.models.ssm``), on the CPU, both sides on the same
weights (the reference's ``init_ssm`` / ``init_lm`` trees through
``interop.lm_params_from_numpy``), float32 model dtype.

Bounds, as ``assert_allclose(rtol=tol, atol=tol)`` or per token row
(``test_torch_lm.assert_rows_close``, see that file's docstring):

* ``_causal_conv``: 1e-6; ``ssm_forward`` across several chunks (and its
  returned state), ``ssm_decode`` and its state: 1e-5 (f32 policy);
* the ``return_state`` state against stepping ``ssm_decode`` over the
  same prompt, both in the port: 1e-4 (the chunked form and the
  recurrence sum in different orders; the JAX package's own
  consistency tests use 2e-2 on logits);
* mamba2 and jamba (M + A + E) smoke forward, prefill, decode and the
  states written: 1e-5 under f32, 5e-4 per row packed under tnn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core.policy import POLICIES as JPOLICIES
from repro.models import ssm as jssm
from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.core.policy import POLICIES
from repro_torch.models import model, ssm
from repro_torch.models.kvcache import init_caches

from test_torch_lm import B, TL, _case, _close, _np, assert_rows_close

ARCHS = ["mamba2-1.3b", "jamba-1.5-large-398b"]
POLICY_TOL = {"f32": 1e-5, "tnn": 5e-4}


def _pair(arch="mamba2-1.3b", seed=0, **kw):
    jcfg = jget_smoke(arch).with_(dtype=jnp.float32, **kw)
    tcfg = get_smoke(arch).with_(dtype=torch.float32, **kw)
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), jcfg)
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    got = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch,chunks", [("mamba2-1.3b", 1), ("mamba2-1.3b", 3),
                                         ("jamba-1.5-large-398b", 2)])
def test_ssm_forward_and_state_match_jax(arch, chunks):
    """Chunked SSD across ``chunks`` chunks (2 groups on jamba), and the
    state it returns."""
    jcfg, tcfg, jp, tp = _pair(arch, seed=chunks)
    s = jcfg.ssm_chunk * chunks
    x = _x(jcfg, 2, s, seed=2)
    jy, jst = jssm.ssm_forward(jp, jnp.asarray(x), jcfg, JPOLICIES["f32"], return_state=True)
    ty, tst = ssm.ssm_forward(tp, torch.from_numpy(x), tcfg, POLICIES["f32"],
                              return_state=True)
    _close(ty, jy)
    for key in ("conv", "h"):
        _close(tst[key], jst[key])
    assert torch.equal(ssm.ssm_forward(tp, torch.from_numpy(x), tcfg, POLICIES["f32"]), ty)
    assert tuple(ty.shape) == x.shape


def test_ssm_decode_matches_jax():
    jcfg, tcfg, jp, tp = _pair(seed=3)
    rng = np.random.default_rng(3)
    state = {"conv": rng.standard_normal((2, jcfg.ssm_conv - 1,
                                          tcfg.ssm_d_inner + 2 * tcfg.ssm_state)
                                         ).astype(np.float32),
             "h": rng.standard_normal(tuple(ssm.init_ssm_state(tcfg, 2, device="cpu")["h"]
                                            .shape)).astype(np.float32)}
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    for t in range(3):
        x = _x(jcfg, 2, 1, seed=10 + t)
        jy, jstate = jssm.ssm_decode(jp, jnp.asarray(x), jcfg, JPOLICIES["f32"], jstate)
        ty, tstate = ssm.ssm_decode(tp, torch.from_numpy(x), tcfg, POLICIES["f32"], tstate)
        _close(ty, jy)
        for key in ("conv", "h"):
            _close(tstate[key], jstate[key])


def test_return_state_equals_stepping_decode():
    """The state after a chunked prefill equals the state reached by
    stepping ``ssm_decode`` over the same prompt from zeros, and the
    outputs agree position by position."""
    _, tcfg, _, tp = _pair(seed=4)
    s = 2 * tcfg.ssm_chunk
    x = torch.from_numpy(_x(tcfg, 2, s, seed=5))
    y, st = ssm.ssm_forward(tp, x, tcfg, POLICIES["f32"], return_state=True)
    state = ssm.init_ssm_state(tcfg, 2, device="cpu")
    ys = []
    for t in range(s):
        yt, state = ssm.ssm_decode(tp, x[:, t:t + 1], tcfg, POLICIES["f32"], state)
        ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(), rtol=1e-4, atol=1e-4)
    for key in ("conv", "h"):
        np.testing.assert_allclose(state[key].numpy(), st[key].numpy(), rtol=1e-4,
                                   atol=1e-4)


def _assert_states(pairs, tol, what):
    for i, (jc, tc) in enumerate(pairs):
        keys = ("conv", "h") if "h" in tc else ("k", "v")
        if "pos" in tc:
            np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        for key in keys:
            assert_rows_close(tc[key], jc[key], tol, f"{what} cache {i} {key}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("policy", list(POLICY_TOL))
def test_smoke_forward_prefill_decode_match_jax(arch, policy):
    """The whole smoke model (``test_torch_lm._case``: forward, prefill of
    5 tokens, per-row decode of the rest) and every state written."""
    c = _case(arch, policy)
    tol = POLICY_TOL[policy]
    jl, tl = c["fwd"]
    assert torch.isfinite(tl).all()
    assert_rows_close(tl, jl, tol, f"{arch}/{policy} forward")
    assert_rows_close(c["hidden"][1], c["hidden"][0], tol, f"{arch}/{policy} hidden")
    jl, tl, caches = c["prefill"]
    assert_rows_close(tl, jl, tol, f"{arch}/{policy} prefill")
    _assert_states(caches, tol, f"{arch}/{policy} prefill")
    steps, caches = c["decode"]
    for t, (jl, tl) in enumerate(steps):
        assert_rows_close(tl, jl, tol, f"{arch}/{policy} decode {t}")
    _assert_states(caches, tol, f"{arch}/{policy} decode")


def test_ssm_caches_and_prefill_decode_consistency():
    """``init_caches`` builds the period-stacked SSM states; greedy decode
    after a prefill matches the full forward's argmax."""
    cfg = get_smoke("mamba2-1.3b").with_(dtype=torch.float32)
    caches = init_caches(cfg, TL, B, 16, device="cpu")
    assert set(caches[0]) == {"conv", "h"}
    assert caches[0]["h"].shape == (cfg.num_periods, B, cfg.ssm_ngroups,
                                    cfg.ssm_nheads // cfg.ssm_ngroups, cfg.ssm_state,
                                    cfg.ssm_headdim)
    assert caches[0]["conv"].dtype == torch.float32 and not caches[0]["h"].any()
    params = model.init_lm(torch.Generator().manual_seed(6), cfg, TL, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, 9), generator=torch.Generator().manual_seed(7))
    full, _ = model.forward(params, {"tokens": toks}, cfg, TL)
    pre, caches = model.prefill(params, {"tokens": toks[:, :8]}, caches, cfg, TL)
    assert caches[0]["h"].abs().sum() > 0
    step, _ = model.decode_step(params, {"tokens": toks[:, 8:9]}, caches, 8, cfg, TL)
    np.testing.assert_allclose(_np(step[:, 0]), _np(full[:, 8]), rtol=1e-4, atol=1e-4)
    assert torch.equal(pre[:, -1].argmax(-1), full[:, 7].argmax(-1))
