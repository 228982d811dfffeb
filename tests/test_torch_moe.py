"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``), on the CPU, both sides on the same
weights (the reference's ``init_moe`` / ``init_lm`` / ``pack_lm_params``
trees through ``interop.lm_params_from_numpy``), float32 model dtype.

Bounds, as ``assert_allclose(rtol=tol, atol=tol)`` or per token row
(``test_torch_lm.assert_rows_close``: one row in eight may sit a
rounding step away, within 1e-2; see that file's docstring):

* ``moe_ffn`` under the f32 policy, capacity drops, shared expert and
  whole-model smoke forward / prefill / decode: 1e-5; the aux loss:
  rtol 1e-5;
* packed ``tnn`` experts: the integer cores equal (``packed_matmul`` of
  each expert of the reference's stacked container, fed the reference's
  activation planes); ``moe_ffn`` and the smoke runs 5e-4 per row;
* the dense per-token reference (no capacity limit): 2e-4, the JAX
  package's own bound (``tests/test_moe.py``);
* the combine: ``torch.equal`` between two runs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core.policy import POLICIES as JPOLICIES
from repro.kernels import ops as jops
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models.packing import pack_lm_params as jpack_lm_params
from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.core.policy import POLICIES
from repro_torch.kernels import ops
from repro_torch.kernels.modes import QuantMode
from repro_torch.kernels.qtensor import QTensor
from repro_torch.models import model, moe
from repro_torch.models.packing import pack_lm_params

from test_torch_lm import B, JL, _case, _configs, _np, assert_rows_close

ARCHS = ["mixtral-8x22b", "qwen2-moe-a2.7b"]
POLICY_TOL = {"f32": 1e-5, "tnn": 5e-4}


def _pair(arch, seed=0, **kw):
    jcfg = jget_smoke(arch).with_(dtype=jnp.float32, **kw)
    tcfg = get_smoke(arch).with_(dtype=torch.float32, **kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _run(jcfg, tcfg, jp, tp, x, policy="f32"):
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, JPOLICIES[policy])
    ty, taux = moe.moe_ffn(tp, torch.from_numpy(x), tcfg, POLICIES[policy])
    return (jy, jaux), (ty, taux)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
def test_moe_ffn_f32_matches_jax(arch, cf):
    """Router, dispatch (drops at cf 1.25 and 0.25), experts, combine,
    shared expert and aux loss on the same weights."""
    jcfg, tcfg, jp, tp = _pair(arch, capacity_factor=cf)
    x = _x(jcfg, 2, 16, seed=1)
    (jy, jaux), (ty, taux) = _run(jcfg, tcfg, jp, tp, x)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    assert taux.dtype == torch.float32
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)


def _dense_reference(params, x, cfg):
    """Every token through its top-k experts, no capacity limit (float64)."""
    xd = x.double()
    probs = torch.softmax(xd @ params["router"].double(), -1)
    top_p, top_i = torch.topk(probs, cfg.num_experts_per_tok)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    y = torch.zeros_like(xd)
    for e in range(cfg.num_experts):
        h = torch.nn.functional.silu(xd @ params["gate"]["w"][e].double()) * (
            xd @ params["up"]["w"][e].double())
        w = torch.where(top_i == e, top_p, 0.0).sum(-1)
        y = y + (h @ params["down"]["w"][e].double()) * w[..., None]
    return y


def test_moe_matches_dense_reference_and_drops_change_output():
    """No drops at cf 8: equal to the per-token dense sum; cf 0.25 drops
    tokens by position: the output changes and stays finite."""
    _, tcfg, _, tp = _pair("mixtral-8x22b", seed=3, capacity_factor=8.0)
    x = torch.from_numpy(_x(tcfg, 2, 32, seed=2))
    y, aux = moe.moe_ffn(tp, x, tcfg, POLICIES["f32"])
    np.testing.assert_allclose(y.numpy(), _dense_reference(tp, x, tcfg).numpy(),
                               rtol=2e-4, atol=2e-4)
    assert aux.item() > 0
    y_drop, _ = moe.moe_ffn(tp, x, tcfg.with_(capacity_factor=0.25), POLICIES["f32"])
    assert torch.isfinite(y_drop).all()
    assert (y - y_drop).abs().max() > 1e-4
    assert moe.moe_capacity(tcfg.with_(capacity_factor=0.25), 32) == 4     # ceil(32*2*.25/4)
    assert moe.moe_capacity(tcfg, 1) == 2                                  # at least k


def test_shared_expert_added_and_matches_jax():
    jcfg, tcfg, jp, tp = _pair("qwen2-moe-a2.7b", seed=4, capacity_factor=8.0)
    x = _x(jcfg, 1, 8, seed=3)
    (jy, _), (ty, _) = _run(jcfg, tcfg, jp, tp, x)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    tp2 = dict(tp)
    tp2["shared"] = {k: {"w": torch.zeros_like(v["w"])} for k, v in tp["shared"].items()}
    y_without, _ = moe.moe_ffn(tp2, torch.from_numpy(x), tcfg, POLICIES["f32"])
    assert (ty - y_without).abs().max() > 1e-5


def test_aux_loss_balanced_router_is_minimal():
    """A uniform router gives the Switch aux loss its minimum, the
    coefficient itself (as the JAX package's test holds it), on both
    sides; the equal probabilities pick the lowest experts first."""
    jcfg, tcfg, jp, tp = _pair("mixtral-8x22b", seed=5, capacity_factor=8.0)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x(jcfg, 2, 64, seed=4)
    (jy, jaux), (ty, taux) = _run(jcfg, tcfg, jp, tp, x)
    np.testing.assert_allclose(taux.item(), tcfg.router_aux_loss, rtol=0.2)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)


def test_combine_is_deterministic():
    """Two runs give the same bits (the combine adds a token's k
    contributions in a fixed order, no float scatter-add)."""
    _, tcfg, _, tp = _pair("qwen2-moe-a2.7b", seed=6, capacity_factor=1.25)
    x = torch.from_numpy(_x(tcfg, 2, 24, seed=5))
    ya, auxa = moe.moe_ffn(tp, x, tcfg, POLICIES["f32"])
    yb, auxb = moe.moe_ffn(tp, x.clone(), tcfg, POLICIES["f32"])
    assert torch.equal(ya, yb) and torch.equal(auxa, auxb)


@functools.lru_cache(maxsize=None)
def _packed_layer(arch):
    """Layer 0's MoE params of the reference's packed (tnn) smoke model,
    both sides."""
    jcfg, tcfg = _configs(arch, "tnn", capacity_factor=1.25)
    jparams = jpack_lm_params(jmodel.init_lm(jax.random.PRNGKey(7), jcfg, JL,
                                             dtype=jnp.float32), jcfg)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["ffn"])
    tparams = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tp = model.take_period(tparams["blocks"][0], 0)["ffn"]
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_expert_cores_equal_jax(arch):
    """Each expert of the reference's (P, E) stacked container, sliced
    with ``QTensor.period`` twice: integer core equal to the reference's
    on the reference's activation planes; ``_expert_matmul`` within the
    packed bound of the reference's (own statistics per expert)."""
    jcfg, tcfg, jp, tp = _packed_layer(arch)
    e = tcfg.num_experts
    rng = np.random.default_rng(8)
    for name, k in (("gate", tcfg.d_model), ("down", tcfg.d_ff)):
        tq = tp[name]
        assert isinstance(tq, QTensor) and tq.stacked
        assert tq.payload["plus"].shape[0] == e and tq.shape == (k, tq.out_features)
        h = rng.standard_normal((e, 6, k)).astype(np.float32)
        for i in range(e):
            jq = jax.tree.map(lambda a: a[i], jp[name])
            xa = jops.quantize_activations(jnp.asarray(h[i]), jq.mode)
            want = np.asarray(jops.packed_matmul(xa, jq, backend="xla"))
            txa = {kk: torch.from_numpy(np.array(xa[kk]).view(np.int32))
                   for kk in ("plus", "minus")}
            got = ops.packed_matmul(txa, tq.period(i), backend="cuda")
            np.testing.assert_array_equal(got.numpy(), want)
        jy = jmoe._expert_matmul(jp[name], jnp.asarray(h), QuantMode.TNN, "xla")
        ty = moe._expert_matmul(tq, torch.from_numpy(h), QuantMode.TNN, "cuda")
        assert_rows_close(ty, jy, POLICY_TOL["tnn"], f"{arch} {name} experts")


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_moe_ffn_matches_jax_and_qat(arch):
    """moe_ffn on the packed experts: within the packed bound of the JAX
    package's on the same containers; bit-equal to the port's QAT run on
    master weights (the same packing per call) and to the plain backend."""
    jcfg, tcfg, jp, tp = _packed_layer(arch)
    x = _x(jcfg, 2, 16, seed=9)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, JPOLICIES["tnn"])
    ty, taux = moe.moe_ffn(tp, torch.from_numpy(x), tcfg, POLICIES["tnn"])
    assert_rows_close(ty, jy, POLICY_TOL["tnn"], f"{arch} packed moe_ffn")
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)
    master = moe.init_moe(torch.Generator().manual_seed(10), tcfg, device="cpu")
    packed = pack_lm_params({"blocks": [{"ffn": master}]}, tcfg)["blocks"][0]["ffn"]
    assert isinstance(packed["up"], QTensor) and packed["up"].stacked
    assert not isinstance(packed["router"], QTensor)
    xt = torch.from_numpy(x)
    y_packed, _ = moe.moe_ffn(packed, xt, tcfg, POLICIES["tnn"])
    y_qat, _ = moe.moe_ffn(master, xt, tcfg, POLICIES["tnn"])
    y_plain, _ = moe.moe_ffn(packed, xt, tcfg, POLICIES["tnn"].with_backend("torch"))
    assert torch.equal(y_packed, y_qat) and torch.equal(y_packed, y_plain)


def _assert_caches(pairs, tol, what):
    for i, (jc, tc) in enumerate(pairs):
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        for key in ("k", "v"):
            assert_rows_close(tc[key], jc[key], tol, f"{what} cache {i} {key}")


CASES = [(a, p) for a in ARCHS for p in POLICY_TOL]


@pytest.mark.parametrize("arch,policy", CASES)
def test_smoke_forward_prefill_decode_match_jax(arch, policy):
    """The whole smoke model (``test_torch_lm._case``: forward, prefill of
    5 tokens, decode of the rest, per-row steps) and the caches written."""
    c = _case(arch, policy)
    tol = POLICY_TOL[policy]
    jl, tl = c["fwd"]
    assert torch.isfinite(tl).all()
    assert_rows_close(tl, jl, tol, f"{arch}/{policy} forward")
    assert_rows_close(c["hidden"][1], c["hidden"][0], tol, f"{arch}/{policy} hidden")
    jl, tl, caches = c["prefill"]
    assert tl.shape[:2] == (B, 1)
    assert_rows_close(tl, jl, tol, f"{arch}/{policy} prefill")
    _assert_caches(caches, tol, f"{arch}/{policy} prefill")
    steps, caches = c["decode"]
    for t, (jl, tl) in enumerate(steps):
        assert_rows_close(tl, jl, tol, f"{arch}/{policy} decode {t}")
    _assert_caches(caches, tol, f"{arch}/{policy} decode")
    assert _np(tl).shape[1] == 1
