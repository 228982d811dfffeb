"""The port's LM stack (``repro_torch.models``, ``configs``, ``core.policy``)
against the JAX package, on the CPU, on the smoke configs of the six
dense-attention archs (float32 model dtype), both sides on the same
weights: the reference's ``init_lm`` (or ``pack_lm_params``) tree loaded
through ``interop.lm_params_from_numpy``.

Bounds, as ``assert_allclose(rtol=tol, atol=tol)``:

* norms, RoPE, softcap: 1e-6; ``head_layout``: equal (tp 1 and 16);
* one layer fed the same input — ``attention``, ``decode_attention``
  (bf16 and int8 caches, per-row steps, a ring window), ``ffn``, a whole
  block — and the hidden state before the head: 1e-5; the int8 score
  and mix accumulators: equal;
* ``forward``, ``prefill`` and ``decode_step`` logits (and the caches
  written): 1e-5 under the f32/bf16 policies, 5e-4 (the reference's own
  packed-serving bound) packed under tnn/bnn, per token row, with one
  allowance: the two frameworks sum float32 products in different orders,
  so values that meet a rounding step — a bf16 cast (the head's operands,
  the bf16 projections) or a ternary/binary threshold — can round to
  neighbouring steps on the two sides.  Such a row must still lie within
  ``FLIP_TOL`` (1e-2, the size of one such step's effect), and at most
  one row in eight (at least one) may be such a row; greedy argmax
  equal on every row whose top-two gap exceeds ``FLIP_TOL``.

Plus the twins of ``tests/test_packed_serving.py`` (packed == QAT,
bytes shrink, other leaves untouched) and ``tests/test_configs_smoke.py``
(prefill/decode consistency), the policies, and the archs that wait for
the next slice.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import model as jmodel
from repro.models.kvcache import init_caches as jinit_caches
from repro.models.packing import pack_lm_params as jpack_lm_params
from repro_torch import interop
from repro_torch.configs import all_cells, get_config, get_smoke, list_archs
from repro_torch.core.policy import POLICIES
from repro_torch.kernels import ops
from repro_torch.kernels.modes import QuantMode
from repro_torch.kernels.qtensor import QTensor
from repro_torch.models import attention, blocks, common, ffn, model
from repro_torch.models.kvcache import INVALID_POS, init_caches
from repro_torch.models.packing import pack_lm_params

ARCHS = ["tinyllama-1.1b", "gemma2-27b", "starcoder2-7b", "minitron-4b",
         "chameleon-34b", "musicgen-large"]
LATER = ["mixtral-8x22b", "qwen2-moe-a2.7b", "mamba2-1.3b", "jamba-1.5-large-398b"]
POLICY_TOL = {"f32": 1e-5, "bf16": 1e-5, "tnn": 5e-4, "bnn": 5e-4}
FLIP_TOL = 1e-2
JL, TL = jcommon.ShardLayout(tp=1), common.ShardLayout(tp=1)
B, S, PROMPT, MAX_LEN = 2, 8, 5, 16


def _np(t):
    return t.detach().cpu().double().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float64)


def assert_rows_close(got, ref, tol, what=""):
    """Every token row within ``tol`` but for rounding-step rows (see the
    module docstring); greedy argmax equal away from near ties."""
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape, (what, g.shape, r.shape)
    g2, r2 = g.reshape(-1, g.shape[-1]), r.reshape(-1, r.shape[-1])
    excess = (np.abs(g2 - r2) - tol * (1 + np.abs(r2))).max(axis=-1)
    off = int((excess > 0).sum())
    assert off <= max(1, len(r2) // 8), f"{what}: {off}/{len(r2)} rows past {tol}"
    np.testing.assert_allclose(g2, r2, rtol=FLIP_TOL, atol=FLIP_TOL, err_msg=what)
    top2 = np.sort(r2, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > FLIP_TOL
    np.testing.assert_array_equal(g2.argmax(-1)[clear], r2.argmax(-1)[clear], err_msg=what)


def _inputs(cfg, s, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "embeddings":
        a = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
        return ({"embeddings": jnp.asarray(a)}, {"embeddings": torch.from_numpy(a)})
    a = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    return ({"tokens": jnp.asarray(a)}, {"tokens": torch.from_numpy(a).long()})


def _slice(batch, t0, t1):
    return {k: v[:, t0:t1] for k, v in batch.items()}


def _configs(arch, policy, **kw):
    return (jget_smoke(arch).with_(dtype=jnp.float32, quant_policy=policy, **kw),
            get_smoke(arch).with_(dtype=torch.float32, quant_policy=policy, **kw))


@functools.lru_cache(maxsize=None)
def _case(arch, policy):
    """Reference and port runs of one (arch, policy) on the same weights:
    forward, prefill of PROMPT tokens, decode of the rest."""
    jcfg, tcfg = _configs(arch, policy)
    params = jmodel.init_lm(jax.random.PRNGKey(0), jcfg, JL, dtype=jnp.float32)
    if policy in ("tnn", "bnn"):
        params = jpack_lm_params(params, jcfg)
    tparams = interop.lm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    jb, tb = _inputs(jcfg, S)
    out = {"tparams": tparams, "tcfg": tcfg}
    out["fwd"] = (jmodel.forward(params, jb, jcfg, JL)[0], model.forward(tparams, tb, tcfg, TL)[0])
    out["hidden"] = (jmodel.forward_hidden(params, jb, jcfg, JL)[0],
                     model.forward_hidden(tparams, tb, tcfg, TL)[0])
    jc = jinit_caches(jcfg, JL, B, MAX_LEN, dtype=jnp.float32)
    tc = init_caches(tcfg, TL, B, MAX_LEN, dtype=torch.float32, device="cpu")
    jl, jc = jmodel.prefill(params, _slice(jb, 0, PROMPT), jc, jcfg, JL)
    tl, tc = model.prefill(tparams, _slice(tb, 0, PROMPT), tc, tcfg, TL)
    out["prefill"] = (jl, tl, [(dict(a), {k: v.clone() for k, v in b.items()})
                               for a, b in zip(jc, tc)])
    steps = []
    for t in range(PROMPT, S):
        jl, jc = jmodel.decode_step(params, _slice(jb, t, t + 1), jc,
                                    jnp.full((B,), t, jnp.int32), jcfg, JL)
        tl, tc = model.decode_step(tparams, _slice(tb, t, t + 1), tc,
                                   torch.full((B,), t, dtype=torch.int32), tcfg, TL)
        steps.append((jl, tl))
    out["decode"] = (steps, list(zip(jc, tc)))
    return out


def _assert_caches(pairs, tol, what):
    for i, (jc, tc) in enumerate(pairs):
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        for key in ("k", "v"):
            assert_rows_close(tc[key], jc[key], tol, f"{what} cache {i} {key}")


CASES = [(a, p) for a in ARCHS for p in POLICY_TOL]


@pytest.mark.parametrize("arch,policy", CASES)
def test_forward_matches_jax(arch, policy):
    c = _case(arch, policy)
    jl, tl = c["fwd"]
    vp = TL.pad_vocab(c["tcfg"].vocab_size)
    assert tl.shape == (B, S, vp) and tl.dtype == torch.float32
    assert torch.isfinite(tl).all()
    assert_rows_close(tl, jl, POLICY_TOL[policy], f"{arch}/{policy} forward")
    jh, th = c["hidden"]
    assert_rows_close(th, jh, POLICY_TOL[policy], f"{arch}/{policy} hidden")


@pytest.mark.parametrize("arch,policy", CASES)
def test_prefill_matches_jax(arch, policy):
    jl, tl, caches = _case(arch, policy)["prefill"]
    assert tl.shape[:2] == (B, 1)
    assert_rows_close(tl, jl, POLICY_TOL[policy], f"{arch}/{policy} prefill")
    _assert_caches(caches, POLICY_TOL[policy], f"{arch}/{policy} prefill")


@pytest.mark.parametrize("arch,policy", CASES)
def test_decode_matches_jax(arch, policy):
    steps, caches = _case(arch, policy)["decode"]
    for t, (jl, tl) in enumerate(steps, PROMPT):
        assert_rows_close(tl, jl, POLICY_TOL[policy], f"{arch}/{policy} decode t={t}")
    _assert_caches(caches, POLICY_TOL[policy], f"{arch}/{policy} decode")


# ---------------------------------------------------------------------------
# Shared layers and one layer at a time
# ---------------------------------------------------------------------------

def test_norms_rope_softcap_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    s = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    xt, st, bt = (torch.from_numpy(a) for a in (x, s, b))
    pairs = [
        (jcommon.rms_norm(jnp.asarray(x), jnp.asarray(s)), common.rms_norm(xt, st)),
        (jcommon.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)),
         common.layer_norm(xt, st, bt)),
        (jcommon.rope_freqs(16, 1e5), common.rope_freqs(16, 1e5)),
        (jcommon.softcap(jnp.asarray(x * 40), 30.0), common.softcap(xt * 40, 30.0)),
    ]
    pos = np.arange(7, dtype=np.int32)
    pairs.append((jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos)),
                  common.apply_rope(xt, torch.from_numpy(pos))))
    step = np.array([[3], [6]], np.int32)                    # decode: (B, 1)
    pairs.append((jcommon.apply_rope(jnp.asarray(x[:, :1]), jnp.asarray(step), 1e5),
                  common.apply_rope(xt[:, :1], torch.from_numpy(step), 1e5)))
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert common.softcap(xt, 0.0) is xt


@pytest.mark.parametrize("tp", [1, 16])
@pytest.mark.parametrize("h,kv", [(32, 4), (24, 8), (36, 4), (64, 8), (4, 2), (32, 32)])
def test_head_layout_matches_jax(tp, h, kv):
    if tp > 1 and (-(-kv // tp) * tp) % kv:
        with pytest.raises(AssertionError):
            attention.head_layout(h, kv, tp)
        return
    want = jattn.head_layout(h, kv, tp)
    got = attention.head_layout(h, kv, tp)
    assert (got.h, got.kv, got.hp, got.kvp, got.g, got.q_src, got.kv_src) == (
        want.h, want.kv, want.hp, want.kvp, want.g, want.q_src, want.kv_src)


def _layer0(arch, policy="f32", **kw):
    jcfg, tcfg = _configs(arch, policy, **kw)
    params = jmodel.init_lm(jax.random.PRNGKey(2), jcfg, JL, dtype=jnp.float32)
    jp = jax.tree.map(lambda a: a[0], params["blocks"][0])
    tp = model.take_period(interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")["blocks"][0], 0)
    x = np.random.default_rng(3).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _close(got, ref, tol=1e-5):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_block_and_ffn_match_jax(arch):
    jcfg, tcfg, jp, tp, x = _layer0(arch)
    pos = np.arange(S, dtype=np.int32)
    window = jcfg.sliding_window if jcfg.layer_pattern[0][0] == "AL" else 0
    ref, _ = jattn.attention(jp["mixer"], jnp.asarray(x), jnp.asarray(pos), jcfg, JL,
                             window=window, q_chunk=3)
    got, _ = attention.attention(tp["mixer"], torch.from_numpy(x), torch.from_numpy(pos),
                                 tcfg, TL, window=window, q_chunk=3)
    _close(got, ref)
    _close(ffn.ffn(tp["ffn"], torch.from_numpy(x), tcfg.policy),
           jffn.ffn(jp["ffn"], jnp.asarray(x), jcfg.policy))
    mixer, ffn_kind = jcfg.layer_pattern[0]
    ref, _, _ = jblocks.block_forward(jp, jnp.asarray(x), jnp.asarray(pos), jcfg, JL,
                                      mixer, ffn_kind)
    got, _, aux = blocks.block_forward(tp, torch.from_numpy(x), torch.from_numpy(pos),
                                       tcfg, TL, mixer, ffn_kind)
    _close(got, ref)
    assert aux == 0.0


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("window", [0, 4])
def test_decode_attention_matches_jax(kv_dtype, window):
    """Prefill 6 tokens into a cache (a 4-slot ring when windowed: the
    prompt overflows it), then decode with per-row steps, the rows at
    different positions; output and cache after every step."""
    jcfg, tcfg, jp, tp, x = _layer0("gemma2-27b", sliding_window=window or 64)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if kv_dtype == "bf16"
                else (jnp.int8, torch.int8))
    length = window or MAX_LEN
    hl = attention.head_layout(jcfg.num_heads, jcfg.num_kv_heads, 1)
    shape = (B, length, hl.kvp, jcfg.head_dim_)
    jc = {"k": jnp.zeros(shape, jdt), "v": jnp.zeros(shape, jdt),
          "pos": jnp.full((B, length), INVALID_POS, jnp.int32)}
    tc = {"k": torch.zeros(shape, dtype=tdt), "v": torch.zeros(shape, dtype=tdt),
          "pos": torch.full((B, length), INVALID_POS, dtype=torch.int32)}
    pos = np.arange(6, dtype=np.int32)
    ref, jc = jattn.attention(jp["mixer"], jnp.asarray(x[:, :6]), jnp.asarray(pos), jcfg,
                              JL, window=window, cache_update=jc)
    got, tc2 = attention.attention(tp["mixer"], torch.from_numpy(x[:, :6]),
                                   torch.from_numpy(pos), tcfg, TL, window=window,
                                   cache_update=tc)
    assert tc2 is tc
    _close(got, ref)
    for step in ([6, 6], [7, 9], [8, 12]):
        xs = x[:, 6:7] * (1 + step[0] % 3)
        sv = np.array(step, np.int32)
        ref, jc = jattn.decode_attention(jp["mixer"], jnp.asarray(xs), jcfg, JL, jc,
                                         jnp.asarray(sv), window=window)
        got, tc = attention.decode_attention(tp["mixer"], torch.from_numpy(xs), tcfg, TL,
                                             tc, torch.from_numpy(sv), window=window)
        what = f"{kv_dtype} window={window} step={step}"
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]), what)
        if kv_dtype == "int8":
            # a value on a rounding step of the static scale may land one
            # grid step apart on the two sides; nearly all are equal
            for key in ("k", "v"):
                d = np.abs(tc[key].numpy().astype(np.int32) - np.asarray(jc[key], np.int32))
                assert d.max() <= 1 and (d == 0).mean() > 0.99, (what, key)
            tol = 2e-2
        else:
            for key in ("k", "v"):
                _close(tc[key].float(), np.asarray(jc[key], np.float32), 1e-2)
            tol = 1e-2
        _close(got, ref, tol)


def test_int8_accumulators_match_jax():
    rng = np.random.default_rng(4)
    qg = (rng.standard_normal((2, 3, 2, 64)) * 3).astype(np.float32)
    nk = rng.integers(-127, 128, (2, 40, 3, 64)).astype(np.int8)
    probs = rng.random((2, 3, 2, 40)).astype(np.float32)
    np.testing.assert_array_equal(
        attention._int8_scores(torch.from_numpy(qg), torch.from_numpy(nk)).numpy(),
        np.asarray(jattn._int8_scores(jnp.asarray(qg), jnp.asarray(nk))))
    np.testing.assert_array_equal(
        attention._int8_mix(torch.from_numpy(probs), torch.from_numpy(nk)).numpy(),
        np.asarray(jattn._int8_mix(jnp.asarray(probs), jnp.asarray(nk))))
    # past 2**24 the exact product runs in float64: a cache of 2000 slots
    a = torch.full((1, 2000), 127, dtype=torch.int8)
    acc = attention._int8_product("bl,bl->b", a, a, 2000)
    assert acc.item() == 127 * 127 * 2000


# ---------------------------------------------------------------------------
# Twins of test_packed_serving.py and test_configs_smoke.py
# ---------------------------------------------------------------------------

def test_packed_project_matches_qat_path():
    g = torch.Generator().manual_seed(5)
    w = torch.randn((96, 24), generator=g)
    x = torch.randn((5, 96), generator=g)
    for mode in (QuantMode.TNN, QuantMode.TBN, QuantMode.BNN):
        packed = ops.pack_weights(w, mode)
        assert torch.equal(attention.project(packed, x, mode, "torch"),
                           ops.quantized_matmul(x, w, mode, "torch"))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-27b"])
@pytest.mark.parametrize("policy", ["tnn", "bnn", "int8"])
def test_packed_lm_decode_matches_unpacked(arch, policy):
    """Packed decode == the QAT decode (the same packing per call)."""
    cfg = get_smoke(arch).with_(dtype=torch.float32, quant_policy=policy)
    params = model.init_lm(torch.Generator().manual_seed(6), cfg, TL, device="cpu")
    packed = pack_lm_params(params, cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 1), generator=torch.Generator().manual_seed(7))
    step = torch.zeros((2,), dtype=torch.int32)
    la, _ = model.decode_step(params, {"tokens": toks},
                              init_caches(cfg, TL, 2, 8, dtype=torch.float32, device="cpu"),
                              step, cfg, TL)
    lb, _ = model.decode_step(packed, {"tokens": toks},
                              init_caches(cfg, TL, 2, 8, dtype=torch.float32, device="cpu"),
                              step, cfg, TL)
    if policy == "int8":     # not a low-bit class: nothing packed
        assert packed["blocks"][0]["mixer"]["wq"] is params["blocks"][0]["mixer"]["wq"]
    else:
        assert isinstance(packed["blocks"][0]["mixer"]["wq"], QTensor)
    assert torch.equal(la, lb)


def test_packed_bytes_shrink():
    cfg = get_smoke("tinyllama-1.1b").with_(quant_policy="bnn")
    params = model.init_lm(torch.Generator().manual_seed(8), cfg, TL, dtype=torch.bfloat16,
                           device="cpu")
    packed = pack_lm_params(params, cfg)

    def proj_bytes(tree):
        total = 0
        for blk in tree["blocks"]:
            for grp, names in (("mixer", ("wq", "wk", "wv", "wo")),
                               ("ffn", ("gate", "up", "down"))):
                for nm in names:
                    leaf = blk[grp][nm]
                    total += leaf.nbytes() if isinstance(leaf, QTensor) else \
                        leaf["w"].numel() * leaf["w"].element_size()
        return total

    assert proj_bytes(packed) < proj_bytes(params) / 10      # ~16x for binary


def test_pack_preserves_non_projection_leaves_and_stacks_periods():
    cfg = get_smoke("gemma2-27b").with_(quant_policy="tnn", num_layers=4)
    params = model.init_lm(torch.Generator().manual_seed(9), cfg, TL, device="cpu")
    packed = pack_lm_params(params, cfg)
    assert packed["embed"] is params["embed"]
    assert packed["final_norm"]["scale"] is params["final_norm"]["scale"]
    blk, pblk = params["blocks"][1], packed["blocks"][1]
    assert pblk["pre_mixer_norm"]["scale"] is blk["pre_mixer_norm"]["scale"]
    wq = pblk["mixer"]["wq"]
    assert wq.stacked and wq.shape == tuple(blk["mixer"]["wq"]["w"].shape[1:])
    assert wq.payload["plus"].shape[0] == cfg.num_periods == 2
    for r in range(cfg.num_periods):
        want = QTensor.from_dense(blk["mixer"]["wq"]["w"][r], QuantMode.TNN)
        got = wq.period(r)
        assert not got.stacked
        for key in want.payload:
            assert torch.equal(got.payload[key], want.payload[key])
        assert torch.equal(got.scale, want.scale)
    with pytest.raises(ValueError, match="not stacked"):
        wq.period(0).period(0)


def test_stacked_packed_tree_loads_from_jax():
    """The reference's packed tree (stacked containers) through interop:
    period r of each container holds the reference's planes and scale."""
    jcfg = jget_smoke("tinyllama-1.1b").with_(quant_policy="tnn", num_layers=3)
    jp = jpack_lm_params(jmodel.init_lm(jax.random.PRNGKey(3), jcfg, JL,
                                        dtype=jnp.bfloat16), jcfg)
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jq, tq = jp["blocks"][0]["ffn"]["down"], tp["blocks"][0]["ffn"]["down"]
    assert tq.shape == tuple(jq.shape) and tq.stacked
    for r in range(3):
        np.testing.assert_array_equal(tq.period(r).payload["plus"].numpy().view(np.uint32),
                                      np.asarray(jq.payload["plus"][r]))
        np.testing.assert_array_equal(tq.period(r).scale.numpy(), np.asarray(jq.scale[r]))
    assert tp["embed"].dtype == torch.bfloat16       # bf16 leaves stay bf16, exactly
    np.testing.assert_array_equal(tp["embed"].float().numpy(),
                                  np.asarray(jp["embed"], np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """Greedy decode after prefill matches the full forward's argmax."""
    cfg = get_smoke(arch).with_(dtype=torch.float32)
    params = model.init_lm(torch.Generator().manual_seed(10), cfg, TL, device="cpu")
    _, tb = _inputs(cfg, 8, seed=11)
    full, _ = model.forward(params, tb, cfg, TL)
    caches = init_caches(cfg, TL, B, 32, dtype=torch.float32, device="cpu")
    pre, caches = model.prefill(params, tb, caches, cfg, TL)
    assert torch.equal(pre[:, -1].argmax(-1), full[:, -1].argmax(-1))
    assert (caches[0]["pos"][:, :, :8] == torch.arange(8, dtype=torch.int32)).all()
    assert (caches[0]["pos"][:, :, 8:] == INVALID_POS).all()


def test_decode_step_matches_incremental_forward():
    cfg = get_smoke("tinyllama-1.1b").with_(dtype=torch.float32)
    params = model.init_lm(torch.Generator().manual_seed(12), cfg, TL, device="cpu")
    _, tb = _inputs(cfg, 8, seed=13)
    ref, _ = model.forward(params, tb, cfg, TL)
    caches = init_caches(cfg, TL, B, 16, dtype=torch.float32, device="cpu")
    _, caches = model.prefill(params, _slice(tb, 0, 5), caches, cfg, TL)
    for t in range(5, 8):
        logits, caches = model.decode_step(params, _slice(tb, t, t + 1), caches, t, cfg, TL)
        np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, t].numpy(),
                                   rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# Policies and configs
# ---------------------------------------------------------------------------

def test_policies_mirror_the_reference():
    from repro.core.policy import POLICIES as JPOLICIES

    assert sorted(POLICIES) == sorted(JPOLICIES) and len(POLICIES) == 12
    backend = {"xla": "cuda", "dense": "dense", "indexed": "indexed"}
    for name, jp in JPOLICIES.items():
        p = POLICIES[name]
        for cls in ("attn_proj", "ffn_proj", "ssm_proj", "head"):
            assert p.for_class(cls).value == jp.for_class(cls).value
            assert p.backend_for(cls) == backend[jp.backend_for(cls)]
    assert POLICIES["tnn"].validate() is POLICIES["tnn"]
    POLICIES["bnn_dense"].validate()
    plain = get_smoke("tinyllama-1.1b").with_(quant_policy="tnn_dense",
                                               quant_backend="torch").policy
    assert {plain.backend_for(c) for c in ("attn_proj", "ffn_proj", "head")} == {"torch"}


@pytest.mark.parametrize("name", ["tnn_indexed", "bnn_indexed", "tnn_mixed"])
def test_indexed_policies_raise_keyerror(name):
    with pytest.raises(KeyError, match="indexed"):
        POLICIES[name].validate()
    cfg = get_smoke("tinyllama-1.1b").with_(dtype=torch.float32, quant_policy=name)
    params = model.init_lm(torch.Generator().manual_seed(14), cfg, TL, device="cpu")
    with pytest.raises(KeyError, match="indexed"):
        model.forward(params, _inputs(cfg, 4)[1], cfg, TL)


@pytest.mark.parametrize("arch", LATER)
def test_unported_archs_raise(arch):
    cfg = get_smoke(arch)
    assert get_config(arch).name == arch
    with pytest.raises(NotImplementedError, match="not ported yet"):
        model.init_lm(torch.Generator().manual_seed(0), cfg, TL, device="cpu")


def test_config_registry_matches_reference():
    from repro.configs import ARCHS as JARCHS
    from repro.configs import get_smoke as jsmoke

    assert sorted(list_archs()) == sorted(JARCHS) and len(list_archs()) == 10
    skip = {"dtype"}
    for name, jcfg in JARCHS.items():
        for jc, tc in ((jcfg, get_config(name)), (jsmoke(name), get_smoke(name))):
            for f in jc.__dataclass_fields__:
                if f not in skip:
                    assert getattr(tc, f) == getattr(jc, f), (name, f)
            assert tc.dtype == torch.bfloat16
    from repro.configs import all_cells as jall_cells

    assert all_cells() == jall_cells()
    tiny = get_config("tinyllama-1.1b")
    assert (tiny.num_layers, tiny.d_model, tiny.num_heads, tiny.num_kv_heads, tiny.d_ff,
            tiny.vocab_size) == (22, 2048, 32, 4, 5632, 32000)


def test_cache_formats():
    cfg = get_smoke("gemma2-27b")
    caches = init_caches(cfg.with_(kv_cache_dtype="int8"), TL, 2, 100, device="cpu")
    assert caches[0]["k"].dtype == torch.int8 and caches[0]["k"].shape[2] == 64   # ring
    assert caches[1]["k"].shape[2] == 100
    assert init_caches(cfg, TL, 2, 8, device="cpu")[0]["v"].dtype == torch.bfloat16
    for fmt in ("tnn2", "tnn2-oracle"):
        with pytest.raises(NotImplementedError, match="paged"):
            init_caches(cfg.with_(kv_cache_dtype=fmt), TL, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="unknown kv_cache_dtype"):
        init_caches(cfg.with_(kv_cache_dtype="fp8"), TL, 2, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="paged"):
        attention.paged_attention_step(None, None, cfg, TL, None, 0)
