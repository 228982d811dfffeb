"""The port's QuantLinear and ``ops.quantized_matmul`` (QAT forward with
straight-through gradients) against the JAX package, on the CPU.

* forward: the port's ``quantized_matmul`` is ``qmm`` on the weights it
  packs (``torch.equal``); ``qmm`` on the reference's packed weights
  (loaded through ``interop``) with the reference's activation
  statistics passed in is ``array_equal`` to the reference's ``qmm``
  (the forward of its ``quantized_matmul``) for every low-bit mode;
  u8/u4, which take no injected statistics, within 2e-5 of it (the
  reference's jitted scale is a reciprocal multiply); the whole forward
  on each side's own packing and statistics within 2e-5 relative (float
  scales a few ULP apart); F32 within 1e-6
  relative (float32 sums in another order), BF16 within the float32
  summation bound of the bf16-rounded operands;
* gradients against ``jax.grad`` of the reference: both sides compute
  ``g @ w.T`` (masked by ``|x| <= 1`` for the low-bit modes) and
  ``x.T @ g`` in float32, so they agree to float32 summation order:
  ``rtol=atol=1e-5``;
* the twins of ``tests/test_qlinear_conv.py``: QAT == packed (here
  ``torch.equal``: both run ``qmm`` on the same packing), the packed
  shapes, the ternary approximation, an STE training loop with a
  ``torch.optim`` step, the i16 and conv depth guards;
* ``conv2d_quantized`` differentiates, with gradients equal to the
  reference's to ``rtol=atol=1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conv as jconv
from repro.core import quantize as jq
from repro.kernels import ops as jops
from repro.kernels.modes import QuantMode as JMode
from repro_torch import interop
from repro_torch.core import QuantLinear, conv2d_quantized, linear_apply, linear_init
from repro_torch.core.conv import check_conv_depth
from repro_torch.kernels import ops
from repro_torch.kernels.modes import QuantMode
from repro_torch.kernels.qtensor import QTensor

LOWBIT = ["tnn", "tbn", "bnn"]
QUANT = LOWBIT + ["int8", "int4"]


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _jax_stats(x, mode):
    """The reference's eager activation statistics for ``x``."""
    if mode in ("int8", "int4"):
        return None
    xa = jops.quantize_activations(jnp.asarray(x), JMode(mode))
    stats = {"scale": np.asarray(xa["scale"])}
    if mode != "bnn":
        stats["thr"] = np.asarray(jq.ternary_threshold(jnp.asarray(x)))
    return stats


@pytest.mark.parametrize("mode", QUANT)
def test_quantized_matmul_forward_matches_jax(mode):
    rng = np.random.default_rng(3)
    m, k, n = 21, 100, 13
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    # the port's forward is qmm on the weights it packs
    y = ops.quantized_matmul(xt, wt, QuantMode(mode), "torch")
    assert torch.equal(y, ops.qmm(xt, QTensor.from_dense(wt, QuantMode(mode)),
                                  backend="torch"))
    assert torch.equal(ops.quantized_matmul(xt, wt, QuantMode(mode)), y)
    # qmm on the reference's packing with its statistics == the reference
    jqt = jops.pack_weights(jnp.asarray(w), JMode(mode))
    stats = _jax_stats(x, mode)
    qt = interop.qtensor_from_numpy(
        {kk: np.asarray(v) for kk, v in jqt.payload.items()}, np.asarray(jqt.scale),
        None, mode, jqt.shape, zero=None if jqt.zero is None else np.asarray(jqt.zero),
        device="cpu")
    if stats is None:
        # u8/u4 take no injected statistics; the reference's jitted qmm
        # divides by qmax as a reciprocal multiply (tests/test_torch_affine.py
        # holds the cores exactly): float32 scale ULPs apart
        ref = jops._qmm_fwd_value(jnp.asarray(x), jnp.asarray(w), JMode(mode), "xla", True)
        got = ops.qmm(xt, qt)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    else:
        ref = jops.qmm(jnp.asarray(x), jqt, backend="xla",
                       act_stats={kk: jnp.asarray(v) for kk, v in stats.items()})
        np.testing.assert_array_equal(ops.qmm(xt, qt, act_stats=stats).numpy(),
                                      np.asarray(ref))
    # each side on its own packing and statistics
    ref = np.asarray(jops.quantized_matmul(jnp.asarray(x), jnp.asarray(w), JMode(mode),
                                           "xla", True))
    np.testing.assert_allclose(y.numpy(), ref, rtol=2e-5, atol=2e-5 * np.abs(ref).max())


def test_quantized_matmul_float_modes_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((9, 70)).astype(np.float32)
    w = rng.standard_normal((70, 11)).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    ref = np.asarray(jops.quantized_matmul(jnp.asarray(x), jnp.asarray(w), JMode.F32,
                                           "xla", True))
    got = ops.quantized_matmul(xt, wt, QuantMode.F32).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    ref = np.asarray(jops.quantized_matmul(jnp.asarray(x), jnp.asarray(w), JMode.BF16,
                                           "xla", True))
    got = ops.quantized_matmul(xt, wt, QuantMode.BF16).numpy()
    assert got.dtype == np.float32
    xb = xt.to(torch.bfloat16).double().numpy()
    wb = wt.to(torch.bfloat16).double().numpy()
    bound = 70 * 2.0 ** -24 * (np.abs(xb) @ np.abs(wb))
    assert (np.abs(got - ref) <= 2 * bound).all()
    assert (np.abs(got - xb @ wb) <= bound).all()


@pytest.mark.parametrize("mode", QUANT + ["f32", "bf16"])
def test_quantized_matmul_grads_match_jax(mode):
    rng = np.random.default_rng(5)
    m, k, n = 12, 64, 10
    x = (rng.standard_normal((m, k)) * 1.2).astype(np.float32)   # some |x| > 1
    w = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)

    def jloss(xx, ww):
        return jnp.sum(jops.quantized_matmul(xx, ww, JMode(mode), "xla", True) * c)

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    (ops.quantized_matmul(xt, wt, QuantMode(mode)) * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), rtol=1e-5, atol=1e-5)
    if QuantMode(mode).is_lowbit:           # the clip-range mask is there
        assert (xt.grad.numpy()[np.abs(x) > 1] == 0).all()
        assert (np.abs(x) > 1).any()


@pytest.mark.parametrize("mode", QUANT)
def test_qat_vs_packed_consistency(mode):
    layer = QuantLinear(96, 24, mode=QuantMode(mode), backend="torch")
    params = layer.init(_gen(1), device="cpu")
    x = torch.randn((10, 96), generator=_gen(7))
    assert torch.equal(layer.apply(params, x), layer.apply_packed(layer.pack(params), x))


@pytest.mark.parametrize("mode", LOWBIT)
def test_packed_weights_shapes(mode):
    layer = QuantLinear(96, 24, mode=QuantMode(mode))
    packed = layer.pack(layer.init(_gen(2), device="cpu"))
    kw = 96 // 32
    assert packed.mode == QuantMode(mode) and packed.shape == (96, 24)
    if mode == "tnn":
        assert packed.payload["plus"].shape == (24, kw)
        assert packed.payload["minus"].dtype == torch.int32
    else:
        assert packed.payload["bits"].shape == (24, kw)
    assert packed.scale.shape == (24,)


def test_lowbit_approximates_dense():
    layer = QuantLinear(512, 64, mode=QuantMode.TNN)
    params = layer.init(_gen(3), device="cpu")
    x = torch.randn((32, 512), generator=_gen(4))
    y_q = layer.apply(params, x).double()
    y_d = (x @ params["w"]).double()
    assert (torch.linalg.norm(y_q - y_d) / torch.linalg.norm(y_d)).item() < 0.7


def test_ste_training_reduces_loss():
    layer = QuantLinear(64, 16, mode=QuantMode.TNN)
    params = layer.init(_gen(5), device="cpu")
    w = params["w"].requires_grad_(True)
    g = _gen(6)
    x = torch.randn((128, 64), generator=g)
    y_true = x @ (torch.randn((64, 16), generator=g) * 0.5)
    opt = torch.optim.SGD([w], lr=0.05)

    def loss_fn():
        return ((layer.apply({"w": w}, x) - y_true) ** 2).mean()

    l0 = loss_fn().item()
    for _ in range(30):
        opt.zero_grad()
        loss_fn().backward()
        opt.step()
    l1 = loss_fn().item()
    assert np.isfinite(l1) and l1 < l0 * 0.9, (l0, l1)


def test_bias_rides_inside_the_packing():
    layer = QuantLinear(40, 8, mode=QuantMode.TBN, use_bias=True)
    params = layer.init(_gen(8), device="cpu")
    params["b"] = torch.randn((8,), generator=_gen(9))
    x = torch.randn((5, 3, 40), generator=_gen(10))
    y = layer.apply(params, x)
    assert y.shape == (5, 3, 8)
    assert torch.equal(y, layer.apply_packed(layer.pack(params), x))
    assert torch.equal(linear_apply(params, x, QuantMode.TBN), y)
    assert linear_init(_gen(11), 40, 8, device="cpu")["w"].shape == (40, 8)


def test_i16_fidelity_guard():
    with pytest.raises(ValueError, match="k_max"):
        QuantLinear(40000, 8, mode=QuantMode.TNN, paper_accum_i16=True)
    QuantLinear(32000, 8, mode=QuantMode.TNN, paper_accum_i16=True)   # ok
    QuantLinear(40000, 8, mode=QuantMode.BF16, paper_accum_i16=True)  # float: no bound


def test_conv_depth_guard():
    with pytest.raises(ValueError, match="k_max"):
        check_conv_depth(4096, 3, 3)          # 36864 > 32767
    check_conv_depth(3640, 3, 3)              # 32760 <= 32767
    with pytest.raises(ValueError, match="k_max"):
        conv2d_quantized(torch.zeros((1, 4, 4, 4096)), torch.zeros((3, 3, 4096, 2)),
                         QuantMode.TNN, paper_accum_i16=True)


@pytest.mark.parametrize("mode", ["tnn", "bnn", "f32"])
def test_conv2d_quantized_gradients_match_jax(mode):
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((2, 6, 7, 5)) * 1.3).astype(np.float32)
    f = rng.standard_normal((3, 3, 5, 4)).astype(np.float32)
    c = rng.standard_normal((2, 6, 7, 4)).astype(np.float32)

    def jloss(xx, ff):
        return jnp.sum(jconv.conv2d_quantized(xx, ff, JMode(mode), backend="xla") * c)

    jgx, jgf = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(f))
    xt = torch.from_numpy(x).requires_grad_(True)
    ft = torch.from_numpy(f).requires_grad_(True)
    y = conv2d_quantized(xt, ft, QuantMode(mode))
    assert y.shape == (2, 6, 7, 4)
    (y * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(jgf), rtol=1e-5, atol=1e-5)
