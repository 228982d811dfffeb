"""The port's quantizers and bit-plane encodings against the JAX package.

Same inputs (numpy, from a seed) through ``repro.core`` and
``repro_torch.core``.  Bit planes and quantized values must be equal;
float statistics (means over the tensor) are reduced in another order by
torch than by XLA, so they are held to a few float32 ULPs (rtol 2**-20,
8 ULPs at 2**-23).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import quantize as jq
from repro.kernels import modes as jmodes
from repro_torch.core import encoding as tenc
from repro_torch.core import quantize as tq
from repro_torch.kernels import modes as tmodes

STAT_RTOL = 2.0 ** -20   # reduction order differs; a few ULPs of float32


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 100])
def test_pack_unpack_bits_parity(k):
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, (3, k), dtype=np.int32)
    ref = np.asarray(jenc.pack_bits(jnp.asarray(bits)))
    got = tenc.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), ref)
    np.testing.assert_array_equal(tenc.unpack_bits(got, k).numpy(), bits)
    np.testing.assert_array_equal(
        tenc.unpack_bits(torch.from_numpy(ref.view(np.int32).copy()), k).numpy(),
        np.asarray(jenc.unpack_bits(jnp.asarray(ref), k)))
    assert tenc.packed_width(k) == jenc.packed_width(k) == got.shape[-1]


@pytest.mark.parametrize("k", [1, 33, 100])
def test_binary_ternary_pack_parity(k):
    rng = np.random.default_rng(100 + k)
    x = rng.standard_normal((4, k)).astype(np.float32)
    x[:, ::7] = 0.0                                  # exact zeros: +1 / 0
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(_u32(tenc.pack_binary(xt)),
                                  np.asarray(jenc.pack_binary(jnp.asarray(x))))
    for got, ref in zip(tenc.pack_ternary(xt), jenc.pack_ternary(jnp.asarray(x))):
        np.testing.assert_array_equal(_u32(got), np.asarray(ref))
    p, m = tenc.pack_ternary(xt)
    np.testing.assert_array_equal(tenc.unpack_ternary(p, m, k).numpy(),
                                  np.sign(x))
    np.testing.assert_array_equal(tenc.unpack_binary(tenc.pack_binary(xt), k).numpy(),
                                  np.where(x < 0, -1.0, 1.0))


def test_ternarize_binarize_parity():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((64, 96)).astype(np.float32)
    t_ref, a_ref = jq.ternarize(jnp.asarray(x))
    t, a = tq.ternarize(torch.from_numpy(x))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_ref))
    np.testing.assert_allclose(a.item(), float(a_ref), rtol=STAT_RTOL)
    thr = jq.ternary_threshold(jnp.asarray(x))
    np.testing.assert_allclose(tq.ternary_threshold(torch.from_numpy(x)).item(),
                               float(thr), rtol=STAT_RTOL)
    # the threshold injected as the conv path injects it: exact planes
    t2, _ = tq.ternarize(torch.from_numpy(x), threshold=torch.tensor(float(thr)))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(t_ref))
    b_ref, ab_ref = jq.binarize(jnp.asarray(x))
    b, ab = tq.binarize(torch.from_numpy(x))
    np.testing.assert_array_equal(b.numpy(), np.asarray(b_ref))
    np.testing.assert_allclose(ab.item(), float(ab_ref), rtol=STAT_RTOL)


def test_round_half_to_even_pinned():
    halves = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    expect = np.array([-2.0, -2.0, -0.0, 0.0, 2.0, 2.0, 4.0], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(halves)).numpy(), expect)
    np.testing.assert_array_equal(np.asarray(jnp.round(jnp.asarray(halves))), expect)
    # and through the affine quantizer, on values that land on .5 exactly
    q_ref = jq.AffineQuant(scale=jnp.float32(0.5), zero_point=jnp.int32(3), bits=4)
    q = tq.AffineQuant(scale=torch.tensor(0.5), zero_point=torch.tensor(3,
                       dtype=torch.int32), bits=4)
    x = np.array([0.25, 0.75, -0.25, 1.25, 5.0], np.float32)
    np.testing.assert_array_equal(tq.affine_quantize(torch.from_numpy(x), q).numpy(),
                                  np.asarray(jq.affine_quantize(jnp.asarray(x), q_ref)))


@pytest.mark.parametrize("bits", [8, 4])
def test_affine_calibrate_parity(bits):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((16, 24)) * 3 + 0.5).astype(np.float32)
    ref = jq.affine_calibrate(jnp.asarray(x), bits)
    got = tq.affine_calibrate(torch.from_numpy(x), bits)
    np.testing.assert_allclose(got.scale.item(), float(ref.scale), rtol=STAT_RTOL)
    assert int(got.zero_point) == int(ref.zero_point)
    np.testing.assert_array_equal(tq.affine_quantize(torch.from_numpy(x), got).numpy(),
                                  np.asarray(jq.affine_quantize(jnp.asarray(x), ref)))


def test_overflow_bounds_parity():
    for p, q, su in [(1, 16, True), (8, 16, False), (4, 16, False), (8, 32, False)]:
        assert tq.k_max(p, q, signed_unit=su) == jq.k_max(p, q, signed_unit=su)
    assert tq.max_conv_in_channels(32767, 3, 3) == jq.max_conv_in_channels(32767, 3, 3)
    for mode in jmodes.QuantMode:
        assert tmodes.accumulator_bound(tmodes.QuantMode(mode.value)) == \
            jmodes.accumulator_bound(mode)
    assert tmodes.DEFAULT_BACKEND == "cuda"
