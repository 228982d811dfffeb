"""The port's optimizer (``repro_torch.optim``) against the JAX
package's, on the CPU, on the same numpy inputs.

Bounds:

* ``Q8`` quantize/dequantize, ``compress_int8`` / ``decompress_int8`` and
  the EF round trip: ``array_equal`` to the reference run eagerly (both
  divide by 127).  Under ``jax.jit`` XLA multiplies by 1/127 instead, so
  the jitted scales may differ by 1 ULP (asserted: at most 1 ULP) — the
  eager reference is the one held exactly;
* ``cosine_schedule``, ``global_norm``, clipping and 1-3 ``adamw_update``
  steps (f32 and int8 moments, with and without clipping and weight
  decay): ``rtol=1e-6`` — float32 arithmetic in the same order; the
  frameworks' sums, ``cos`` and ``pow`` may round their last bit apart.
  An updated leaf is held with ``atol`` 1e-6 x its largest magnitude (a
  value near zero is the difference of two close numbers), and an int8
  moment code may round one step apart;
* the reference's behavioural cases (the quadratic converges, int8
  moments track f32, the EF residual is carried, Q8 shapes and its
  error bound) on the port, with the reference's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch import interop
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, clip_by_global_norm,
                               compress_int8, cosine_schedule, decompress_int8,
                               ef_compress_update, ef_state_init, global_norm)
from repro_torch.optim.adamw import Q8
from repro_torch.tree import flatten_with_paths

SHAPES = [(7, 130), (6, 512), (130,), (), (3, 4, 256), (2, 1024)]


def _x(shape, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return np.asarray(rng.standard_normal(shape) * scale, np.float32)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES)
def test_q8_equal_reference(shape):
    x = _x(shape)
    got, want = Q8.quantize(torch.from_numpy(x)), jadamw.Q8.quantize(jnp.asarray(x))
    assert got.q.dtype == torch.int8 and tuple(got.q.shape) == shape
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))
    jitted = jax.jit(jadamw.Q8.quantize)(jnp.asarray(x))
    assert _ulps(got.scale.numpy(), jitted.scale).max() <= 1


@pytest.mark.parametrize("shape", SHAPES)
def test_compress_int8_equal_reference(shape):
    x = _x(shape, seed=1)
    got, want = compress_int8(torch.from_numpy(x)), jcomp.compress_int8(jnp.asarray(x))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    np.testing.assert_array_equal(decompress_int8(got).numpy(),
                                  np.asarray(jcomp.decompress_int8(want)))
    jitted = jax.jit(jcomp.compress_int8)(jnp.asarray(x))
    assert _ulps(got["scale"].numpy(), jitted["scale"]).max() <= 1


def test_ef_compress_update_equal_reference():
    grads = {"a": _x((16, 8), 2, 1e-3), "b": [_x((5,), 3), _x((3, 3), 4)]}
    err, jerr = ef_state_init(_torch(grads)), jcomp.ef_state_init(_jax(grads))
    for step in range(4):
        sent, err = ef_compress_update(_torch(grads), err)
        jsent, jerr = jcomp.ef_compress_update(_jax(grads), jerr)
        for got, want in ((sent, jsent), (err, jerr)):
            for (k, g), (_, w) in zip(flatten_with_paths(got), _flat(want)):
                np.testing.assert_array_equal(g.numpy(), w, err_msg=f"step {step} {k}")


def _torch(tree):
    return interop.train_state_from_numpy(tree, device="cpu")


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _flat(jtree):
    """[(path, numpy array)] of a reference tree, in the port's order."""
    return [(k, v.numpy()) for k, v in flatten_with_paths(_torch(jax.tree.map(np.asarray,
                                                                               jtree)))]


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 99, 100, 150])
def test_cosine_schedule_matches_reference(step):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    got = float(cosine_schedule(AdamWConfig(**kw), torch.tensor(step)))
    want = float(jadamw.cosine_schedule(jadamw.AdamWConfig(**kw), jnp.asarray(step)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_global_norm_and_clip_match_reference():
    tree = {"w": _x((64, 32), 5), "b": _x((32,), 6), "s": [_x((4, 4), 7)]}
    np.testing.assert_allclose(float(global_norm(_torch(tree))),
                               float(jadamw.global_norm(_jax(tree))), rtol=1e-6)
    got, norm = clip_by_global_norm(_torch(tree), 1.0)
    want, jnorm = jadamw.clip_by_global_norm(_jax(tree), 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for (k, g), (_, w) in zip(flatten_with_paths(got), _flat(want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("moments", ["f32", "int8"])
@pytest.mark.parametrize("clip,wd", [(1.0, 0.1), (0.0, 0.0)])
def test_adamw_update_matches_reference(moments, clip, wd):
    """Three updates from the same params and gradients: params and
    moments (int8 moments: q and scale) to rtol 1e-6."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip, weight_decay=wd,
              moments_dtype=moments)
    cfg, jcfg = AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    params = {"w": _x((8, 512), 8, 0.5), "b": _x((512,), 9, 0.1), "l": [_x((3, 5), 10)]}
    p, jp = _torch(params), _jax(params)
    state, jstate = adamw_init(p, cfg), jadamw.adamw_init(jp, jcfg)
    for step in range(3):
        grads = jax.tree.map(lambda a, s=step: _x(a.shape, 20 + s), params)
        p, state, met = adamw_update(_torch(grads), state, p, cfg)
        jp, jstate, jmet = jadamw.adamw_update(_jax(grads), jstate, jp, jcfg)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        for name in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(met[name]), float(jmet[name]), rtol=1e-6)
        got = flatten_with_paths({"p": p, "m": state["m"], "v": state["v"]})
        want = _flat({"p": jp, "m": jstate["m"], "v": jstate["v"]})
        assert [k for k, _ in got] == [k for k, _ in want]
        for (k, g), (_, w) in zip(got, want):
            if g.dtype == torch.int8:   # a moment's int8 code may round 1 apart
                assert np.abs(g.numpy().astype(int) - w.astype(int)).max() <= 1, k
            else:
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                           atol=1e-6 * np.abs(w).max(),
                                           err_msg=f"step {step} {k}")


@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_adamw_update_by_slices_equals_whole(monkeypatch, moments):
    """A leaf larger than ``_UPDATE_ELEMS`` is updated a slice of its
    leading dim at a time: params and moments ``torch.equal`` to the
    whole-leaf update, a period-stacked 3-D leaf and a 2-D one, rows that
    do not divide the slices, over three steps."""
    from repro_torch.optim import adamw as adamw_mod

    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=1.0,
                      weight_decay=0.1, moments_dtype=moments)
    params = {"s": _x((5, 6, 512), 30, 0.5), "w": _x((7, 512), 31, 0.5), "b": _x((512,), 32)}
    outs = []
    for limit in (adamw_mod._UPDATE_ELEMS, 1024):
        monkeypatch.setattr(adamw_mod, "_UPDATE_ELEMS", limit)
        p = _torch(params)
        state = adamw_init(p, cfg)
        for step in range(3):
            grads = {k: _x(v.shape, 40 + step) for k, v in params.items()}
            p, state, _ = adamw_update(_torch(grads), state, p, cfg)
        outs.append(flatten_with_paths({"p": p, "m": state["m"], "v": state["v"]}))
    for (k, a), (_, b) in zip(*outs):
        assert torch.equal(a, b), k


def _quadratic_losses(cfg, steps=60):
    target = torch.tensor([1.5, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    state = adamw_init(params, cfg)
    losses = []
    for _ in range(steps):
        grads = {"w": 2 * (params["w"] - target)}
        losses.append(float(torch.sum((params["w"] - target) ** 2)))
        params, state, _ = adamw_update(grads, state, params, cfg)
    return losses


def test_adamw_converges_quadratic():
    losses = _quadratic_losses(AdamWConfig(lr=0.1, warmup_steps=1, total_steps=60,
                                           weight_decay=0.0))
    assert losses[-1] < 0.05 * losses[0]


def test_int8_moments_track_f32():
    kw = dict(lr=0.1, warmup_steps=1, total_steps=60, weight_decay=0.0)
    l32 = _quadratic_losses(AdamWConfig(moments_dtype="f32", **kw))
    l8 = _quadratic_losses(AdamWConfig(moments_dtype="int8", **kw))
    assert l8[-1] < 0.1 * l8[0]
    assert abs(l8[-1] - l32[-1]) < 0.1


@pytest.mark.parametrize("seed", range(4))
def test_q8_roundtrip_bounded_error(seed):
    x = torch.from_numpy(_x((7, 130), seed))
    err = torch.abs(Q8.quantize(x).dequantize() - x)
    assert float(err.max()) <= float(torch.abs(x).max()) / 127.0 + 1e-6


def test_q8_shapes_follow_param():
    q = Q8.quantize(torch.zeros((6, 512)))
    assert q.q.shape == (6, 512) and q.q.dtype == torch.int8
    assert q.scale.shape == (6, 2)
    assert Q8.quantize(torch.zeros((130,))).scale.shape == (1,)


def test_error_feedback_unbiased_over_time():
    g = {"w": torch.tensor([1e-3, 2e-3, -5e-4])}
    err = ef_state_init(g)
    total = torch.zeros(3)
    for _ in range(300):
        sent, err = ef_compress_update(g, err)
        total = total + sent["w"]
    np.testing.assert_allclose((total / 300).numpy(), g["w"].numpy(), rtol=0.05)
