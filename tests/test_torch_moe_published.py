"""The published Qwen1.5-MoE block in the port (``ModelConfig.qkv_bias``,
``shared_expert_gate``, ``moe_renormalize``, ``moe_dropless``;
``configs/qwen2_moe_a2_7b.PUBLISHED``) against the benchmark's plain
reference ``gpubench/reference/qwen1_5_moe_a2_7b.py``, on the CPU at the
port's SMOKE sizes with the published switches on, both sides on the
reference's seeded weights (bf16 stream, as the benchmark runs it).

* one block (``blocks.block_forward``) and the whole ``model.prefill``
  against the reference's layer chain: under ``tnn`` (packed, the plain
  ``quant_backend="torch"`` kernels) and under ``f32`` (master weights;
  the reference's ternary projection swapped for a float32 product plus
  the bias).  Both sides round to bf16 at the same places and sum the
  same float32 products in other orders, so a value that meets a bf16
  rounding step can land one step apart: each layer within 2e-2 of the
  norm of what the reference layer added (the benchmark's measure), the
  logits within 2e-2 of their spread;
* prefill, then decode steps through the bf16 cache (f32), against the
  reference's whole prompt up to each token: the prefill's logits
  within 2e-2, each decode step's within 6e-2, since a decode step
  mixes the cache with bf16 probabilities (``decode_attention`` meets
  the cache at its stored width; 0.012–0.024 on four prompts);
* dropless routing: with the router biased so that one expert takes
  over half the choices, the port's output equals the per-token dense
  reference (every token through each of its experts) to 1e-5, while
  the capacity path drops tokens and differs;
* the combine weighs the experts by the router's own top-4 mass
  (``moe_renormalize`` False) or by 1 (True): with every expert the
  same, the routed output over one expert's is that mass, to 1e-5;
* the shared gate and the q/k/v biases each change the output;
* with every new field at its default, ``moe_ffn`` is ``torch.equal``
  to the block before the fields (``_moe_before``, the previous
  single-device code), f32 and packed tnn.  ``test_torch_moe.py`` holds
  that block to the JAX package;
* the routed experts' grouped products (``ops.qmm_grouped``, the rows
  laid out (E, C, D) with zeros past each expert's): each group's rows
  come out as one ``qmm`` of those rows alone, and the rows past its
  count as zeros, under every low-bit mode on the plain kernels
  (``tests/test_torch_kernels_gpu.py`` holds the grouped kernel to the
  plain one).
"""

import copy
import json
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import harness, lm  # noqa: E402
from repro_torch.configs import qwen2_moe_a2_7b  # noqa: E402
from repro_torch.core.policy import POLICIES  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.modes import QuantMode  # noqa: E402
from repro_torch.kernels.qtensor import QTensor  # noqa: E402
from repro_torch.models import blocks, model, moe  # noqa: E402
from repro_torch.models.common import ShardLayout  # noqa: E402
from repro_torch.models.ffn import ffn  # noqa: E402
from repro_torch.models.kvcache import init_caches  # noqa: E402
from repro_torch.models.packing import pack_lm_params  # noqa: E402

REF = harness.load_module("reference", "qwen1_5_moe_a2_7b")
CELL = "qwen2moe.prefill_16x512"
LAYOUT = ShardLayout()
TOL = 2e-2
TOL_DECODE = 6e-2
B, S = 2, 32


def _cfg_dict():
    cfg = json.loads((ROOT / "gpubench" / "configs" / "qwen1_5_moe_a2_7b.json").read_text())
    cut = json.loads((ROOT / "gpubench" / "smoke" / f"{CELL}.json").read_text())
    cfg.update(cut["config"])
    return cfg


def _float_project(x, w, b=None):
    y = x.reshape(-1, x.shape[-1]).to(torch.float32) @ w.to(torch.float32)
    if b is not None:
        y = y + b.to(torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)


@pytest.fixture(params=["tnn", "f32"])
def case(request, monkeypatch):
    """(the config dict, the port's config, the reference's weights, the
    tree the port runs) under one policy."""
    policy = request.param
    if policy == "f32":
        monkeypatch.setattr(REF, "_project", _float_project)
    cfg = _cfg_dict()
    mcfg = lm.model_config(cfg, quant_policy=policy, quant_backend="torch")
    params = REF.make_params(cfg, 2**33 + 7, torch.device("cpu"), torch.bfloat16)
    tree = pack_lm_params(params, mcfg) if policy == "tnn" else params
    return cfg, mcfg, params, tree


def _tokens(cfg, seed=3):
    return torch.from_numpy(REF.make_tokens(cfg, seed, 1, B, S)[0])


def _rel(got, want, x):
    got, want, x = (t.to(torch.float32) for t in (got, want, x))
    return float((got - want).norm() / (want - x).norm())


def test_published_config_switches():
    pub = qwen2_moe_a2_7b.PUBLISHED
    assert (pub.qkv_bias, pub.shared_expert_gate, pub.moe_renormalize, pub.moe_dropless) == \
        (True, True, False, True)
    assert (pub.rope_theta, pub.norm_eps, pub.router_aux_loss) == (1e6, 1e-6, 0.001)
    base = qwen2_moe_a2_7b.CONFIG
    assert (base.qkv_bias, base.shared_expert_gate, base.moe_renormalize, base.moe_dropless) == \
        (False, False, True, False)
    cfg = _cfg_dict()
    full = json.loads((ROOT / "gpubench" / "configs" / "qwen1_5_moe_a2_7b.json").read_text())
    mcfg = lm.model_config(full)
    for key in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
                "num_experts", "num_experts_per_tok", "shared_expert_d_ff",
                *qwen2_moe_a2_7b.PUBLISHED_SWITCHES):
        assert getattr(mcfg, key) == getattr(pub, key), key
    assert mcfg.head_dim_ == pub.head_dim_ == 128
    assert cfg["num_layers"] == 2


def test_block_matches_reference(case):
    cfg, mcfg, params, tree = case
    x = REF.embed(params, _tokens(cfg), cfg)
    positions = torch.arange(S, dtype=torch.int32)
    per_layer = REF.layer_params(params, cfg)
    for r, (pp, p_ref) in enumerate(zip(model._unbind_periods(tree["blocks"], 2), per_layer)):
        with torch.no_grad():
            got = blocks.block_forward(pp[0], x, positions, mcfg, LAYOUT, "A", "E")[0]
        want = REF.layer(p_ref, x, cfg)
        assert got.dtype == want.dtype == torch.bfloat16
        assert _rel(got, want, x) < TOL, r
        x = want


def test_prefill_matches_reference(case):
    cfg, mcfg, params, tree = case
    tokens = _tokens(cfg, seed=5)
    caches = init_caches(mcfg, LAYOUT, B, S, device="cpu")
    with torch.no_grad():
        logits, _ = model.prefill(tree, {"tokens": tokens}, caches, mcfg, LAYOUT)
    x = REF.embed(params, tokens, cfg)
    for p in REF.layer_params(params, cfg):
        x = REF.layer(p, x, cfg)
    want = REF.final_logits(params, x, cfg)
    got = logits[:, 0, :cfg["vocab_size"]]
    assert lm.logit_err(got, want) < TOL


def test_decode_through_the_cache_matches_reference(monkeypatch):
    """f32 (a ternary product's statistics are over the rows it sees, so a
    decode step's differ from the full prompt's): prefill, then decode
    steps through the bf16 cache, each step's logits against the
    reference's whole prompt up to that token."""
    monkeypatch.setattr(REF, "_project", _float_project)
    cfg = _cfg_dict()
    mcfg = lm.model_config(cfg, quant_policy="f32")
    params = REF.make_params(cfg, 2**33 + 7, torch.device("cpu"), torch.bfloat16)
    tokens = _tokens(cfg, seed=6)
    first = S - 3
    caches = init_caches(mcfg, LAYOUT, B, S, device="cpu")
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": tokens[:, :first]}, caches, mcfg,
                                       LAYOUT)
        steps = [logits[:, 0]]
        for t in range(first, S):
            logits, caches = model.decode_step(params, {"tokens": tokens[:, t:t + 1]}, caches,
                                               t, mcfg, LAYOUT)
            steps.append(logits[:, 0])
    for t, got in zip(range(first, S + 1), steps):
        x = REF.embed(params, tokens[:, :t], cfg)
        for p in REF.layer_params(params, cfg):
            x = REF.layer(p, x, cfg)
        err = lm.logit_err(got[:, :cfg["vocab_size"]], REF.final_logits(params, x, cfg))
        assert err < (TOL if t == first else TOL_DECODE), (t, err)


# ---------------------------------------------------------------------------
# moe_ffn alone, float32 model dtype, the f32 policy
# ---------------------------------------------------------------------------

def _moe_case(seed=0, **kw):
    cfg = qwen2_moe_a2_7b.SMOKE.with_(**{**qwen2_moe_a2_7b.PUBLISHED_SWITCHES,
                                         "dtype": torch.float32, **kw})
    g = torch.Generator().manual_seed(seed)
    p = moe.init_moe(g, cfg, device="cpu")
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator().manual_seed(seed + 1))
    return cfg, p, x


def _dense_per_token(p, x, cfg):
    """Every token through each of its top-k experts, weighed by its
    router probability, plus the gated shared expert."""
    probs = torch.softmax(x @ p["router"], dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.num_experts_per_tok
    y = torch.zeros_like(x)
    for j in range(k):
        for e in range(cfg.num_experts):
            sel = top_i[..., j] == e
            h = F.silu(x @ p["gate"]["w"][e]) * (x @ p["up"]["w"][e])
            y = y + torch.where(sel[..., None], top_p[..., j:j + 1] * (h @ p["down"]["w"][e]), 0)
    shared = ffn(p["shared"], x, POLICIES["f32"])
    return y + shared * torch.sigmoid(x @ p["shared_gate"])


@pytest.mark.parametrize("dropless", [True, False])
def test_no_token_dropped_with_a_skewed_router(dropless):
    cfg, p, x = _moe_case(moe_dropless=dropless)
    x = x + 0.5
    p["router"][:, 0] += 0.1                          # expert 0's logit up ~0.1 * 0.5 * d
    top_i = torch.sort(torch.softmax(x @ p["router"], -1), -1, descending=True)[1][..., :4]
    chosen = int((top_i == 0).sum())
    assert chosen > 0.5 * B * S                       # over half the tokens choose expert 0
    assert chosen > moe.moe_capacity(cfg, S) * B      # past its capacity
    y, _ = moe.moe_ffn(p, x, cfg, POLICIES["f32"])
    err = float((y - _dense_per_token(p, x, cfg)).abs().max())
    if dropless:
        assert err < 1e-5
    else:
        assert err > 1e-2                            # the capacity path drops


@pytest.mark.parametrize("renormalize", [False, True])
def test_combine_weighs_by_the_top_k_mass(renormalize):
    cfg, p, x = _moe_case(moe_renormalize=renormalize, shared_expert_d_ff=0)
    for name in ("gate", "up", "down"):
        p[name]["w"][:] = p[name]["w"][0]
    y, _ = moe.moe_ffn(p, x, cfg, POLICIES["f32"])
    one = F.silu(x @ p["gate"]["w"][0]) * (x @ p["up"]["w"][0]) @ p["down"]["w"][0]
    probs = torch.softmax(x @ p["router"], dim=-1)
    mass = torch.sort(probs, dim=-1, descending=True)[0][..., :4].sum(-1, keepdim=True)
    want = one if renormalize else mass * one
    assert not renormalize or float(mass.max()) < 0.99
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("part", ["shared_gate", "qkv_bias"])
def test_part_changes_the_output(case, part):
    cfg, mcfg, params, tree = case
    tokens = _tokens(cfg, seed=9)

    def run(t, c):
        caches = init_caches(c, LAYOUT, B, S, device="cpu")
        with torch.no_grad():
            return model.prefill(t, {"tokens": tokens}, caches, c, LAYOUT)[0]

    if part == "shared_gate":
        without_cfg, without = mcfg.with_(shared_expert_gate=False), tree
    else:
        without_cfg = mcfg
        stripped = copy.deepcopy(params)
        for name in ("wq", "wk", "wv"):
            del stripped["blocks"][0]["mixer"][name]["b"]
        without = pack_lm_params(stripped, mcfg) if mcfg.quant_policy == "tnn" else stripped
    assert lm.logit_err(run(without, without_cfg)[:, 0], run(tree, mcfg)[:, 0]) > 0.1


# ---------------------------------------------------------------------------
# Every new field at its default: the block as it was
# ---------------------------------------------------------------------------

def _moe_before(params, x, cfg, policy):
    """The single-device ``moe_ffn`` before the published block's fields,
    kept verbatim as the defaults' yardstick."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    dev = x.device
    logits = moe.einsum_f32("bsd,de->bse", x, params["router"])
    probs = torch.softmax(logits, dim=-1)
    b, s, d = x.shape
    sk = s * k
    cap = moe.moe_capacity(cfg, s)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    e_flat = top_i.reshape(b, sk)
    se, order = torch.sort(e_flat, dim=-1, stable=True)
    counts = torch.zeros((b, e), dtype=torch.int64, device=dev).scatter_add_(
        1, e_flat, torch.ones_like(e_flat))
    starts = counts.cumsum(dim=-1) - counts
    pos = torch.arange(sk, device=dev)[None, :] - torch.gather(starts, 1, se)
    keep = pos < cap
    dest = se * cap + pos.clamp(0, cap - 1)
    tok = order // k
    rows = torch.arange(b, device=dev)[:, None]
    buf = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=dev)
    buf[rows, torch.where(keep, dest, e * cap)] = x[rows, tok]
    buf = buf[:, :e * cap]
    h_in = buf.reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)
    mode, backend = policy.ffn_proj, policy.backend_for("ffn_proj")
    g = moe._expert_matmul(params["gate"], h_in, mode, backend)
    u = moe._expert_matmul(params["up"], h_in, mode, backend)
    h = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    y_e = moe._expert_matmul(params["down"], h, mode, backend)
    y_buf = y_e.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)
    w_sorted = torch.gather(top_p.reshape(b, sk), 1, order)
    contrib = (y_buf[rows, dest] * keep[..., None].to(y_buf.dtype)
               * w_sorted[..., None].to(y_buf.dtype))
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(sk, device=dev).expand(b, sk))
    slots = torch.sort(rank.reshape(b, s, k), dim=-1).values
    per_tok = contrib[rows[:, :, None], slots]
    y = torch.zeros((b, s, d), dtype=y_buf.dtype, device=dev)
    for j in range(k):
        y = y + per_tok[:, :, j]
    if cfg.shared_expert_d_ff:
        y = y + ffn(params["shared"], x, policy)
    frac_tokens = counts.sum(dim=0).to(torch.float32) / (b * sk)
    frac_probs = probs.mean(dim=(0, 1))
    return y, e * (frac_tokens * frac_probs).sum() * cfg.router_aux_loss


@pytest.mark.parametrize("policy", ["f32", "tnn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_defaults_bit_equal_to_the_block_before(policy, dtype):
    cfg = qwen2_moe_a2_7b.SMOKE.with_(dtype=dtype, quant_policy=policy, quant_backend="torch",
                                      capacity_factor=1.0)
    g = torch.Generator().manual_seed(11)
    params = model.init_lm(g, cfg, LAYOUT, dtype=dtype, device="cpu")
    if policy == "tnn":
        params = pack_lm_params(params, cfg)
    p = model._unbind_periods(params["blocks"], cfg.num_periods)[0][0]["ffn"]
    assert set(p) == {"router", "gate", "up", "down", "shared"}
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator().manual_seed(12)).to(dtype)
    with torch.no_grad():
        y, aux = moe.moe_ffn(p, x, cfg, cfg.policy)
        y0, aux0 = _moe_before(p, x, cfg, cfg.policy)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)
    mixer = params["blocks"][0]["mixer"]
    for name in ("wq", "wk", "wv"):
        assert (mixer[name].bias is None) if policy == "tnn" else ("b" not in mixer[name])


# ---------------------------------------------------------------------------
# The routed experts' grouped products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("mode", ["tnn", "tbn", "bnn", "int8"])
def test_qmm_grouped_is_a_qmm_a_group(mode, backend):
    g = torch.Generator().manual_seed(21)
    sizes, r, k, n = [3, 0, 9, 1, 6], 9, 70, 24
    x = torch.zeros((len(sizes), r, k))
    for i, c in enumerate(sizes):
        x[i, :c] = torch.randn((c, k), generator=g) * (i + 1)    # a scale of each group's own
    qts = [QTensor.stack([ops.pack_weights(torch.randn((k, n), generator=g), QuantMode(mode))
                          for _ in sizes]) for _ in range(2)]
    outs = ops.qmm_grouped(x, qts, torch.tensor(sizes), sizes, backend=backend)
    for out, qt in zip(outs, qts):
        assert out.shape == (len(sizes), r, n) and out.dtype == torch.float32
        for i, c in enumerate(sizes):
            assert not out[i, c:].any()
            if c:
                want = ops.qmm(x[i, :c], qt.period(i), backend=backend)
                np.testing.assert_allclose(out[i, :c].numpy(), want.numpy(),
                                           rtol=1e-6, atol=1e-6)


def test_quantize_groups_takes_each_groups_own_statistics():
    g = torch.Generator().manual_seed(22)
    sizes, r, k = [4, 2, 0, 7], 7, 45
    x = torch.zeros((len(sizes), r, k))
    for i, c in enumerate(sizes):
        # values of the bf16 stream: many share one, so a threshold off by
        # a last bit would move them all
        x[i, :c] = (torch.randn((c, k), generator=g) * 10.0 ** i).to(torch.bfloat16)
    q = ops.quantize_groups(x, torch.tensor(sizes), sizes)
    plus, minus = (t.reshape(len(sizes), r, -1) for t in (q["plus"], q["minus"]))
    for i, c in enumerate(sizes):
        assert not plus[i, c:].any() and not minus[i, c:].any()
        if not c:
            assert float(q["scale"][i]) == 0.0
            continue
        want = ops.quantize_activations(x[i, :c], QuantMode.TNN)
        assert torch.equal(plus[i, :c], want["plus"]) and torch.equal(minus[i, :c], want["minus"])
        np.testing.assert_allclose(float(q["scale"][i]), float(want["scale"]), rtol=1e-6)
