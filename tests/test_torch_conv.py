"""The port's implicit-im2col conv against the JAX package.

* ``conv_act_stats``: float32 sums over every im2col element (thousands
  of terms here), reduced in another order than XLA's — torch sums
  pairwise, XLA's CPU loop does not — so held to rtol 2**-16 (128 ULPs,
  well inside the N*eps bound of a float32 sum of N terms);
* ``qconv`` with the JAX statistics injected against
  ``repro.kernels.ops.qconv``: ``array_equal``, for TNN/TBN/BNN x {3x3 s1
  SAME Cin=32, Cin=8 (positional planes), s2 VALID}.  Most cases are held
  against the reference's ``xla`` backend, which the reference's own
  tests pin bit-identical to ``pallas``; a handful run ``pallas`` in
  interpret mode;
* the port's fused conv against its materializing oracle: ``torch.equal``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conv as jconv
from repro.kernels import conv_fused as jcf
from repro.kernels import ops as jops
from repro.kernels.modes import QuantMode as JMode
from repro_torch import interop
from repro_torch.core import conv as tconv
from repro_torch.kernels import conv_fused, ops
from repro_torch.kernels.modes import QuantMode

STAT_RTOL = 2.0 ** -16
MODES = ["tnn", "tbn", "bnn"]
CASES = {
    # name: (x shape, filter shape, stride, padding)
    "3x3s1same_c32": ((2, 8, 8, 32), (3, 3, 32, 16), 1, "SAME"),
    "3x3s1same_c8": ((2, 7, 6, 8), (3, 3, 8, 5), 1, "SAME"),
    "3x3s2valid": ((1, 9, 11, 32), (3, 3, 32, 7), 2, "VALID"),
}
PALLAS_CASES = {"3x3s1same_c32"}


def _data(case, seed=0):
    xs, fs, stride, padding = CASES[case]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(xs).astype(np.float32),
            rng.standard_normal(fs).astype(np.float32), stride, padding)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_conv_act_stats_parity(mode, case):
    x, f, stride, padding = _data(case)
    kh, kw = f.shape[:2]
    ref = jcf.conv_act_stats(jnp.asarray(x), JMode(mode), kh, kw, stride, padding)
    got = conv_fused.conv_act_stats(torch.from_numpy(x), QuantMode(mode), kh, kw,
                                    stride, padding)
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].item(), float(ref[key]), rtol=STAT_RTOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_qconv_matches_jax_with_injected_stats(mode, case):
    x, f, stride, padding = _data(case, seed=3)
    kh, kw = f.shape[:2]
    jqt = jconv.pack_conv_filters(jnp.asarray(f), JMode(mode))
    stats = jcf.conv_act_stats(jnp.asarray(x), JMode(mode), kh, kw, stride, padding)
    backend = "pallas" if case in PALLAS_CASES else "xla"
    ref = np.asarray(jops.qconv(jnp.asarray(x), jqt, stride=stride, padding=padding,
                                backend=backend, act_stats=stats))
    qt = interop.qtensor_from_numpy({k: np.asarray(v) for k, v in jqt.payload.items()},
                                    np.asarray(jqt.scale), None, mode, jqt.shape,
                                    jqt.geometry, device="cpu")
    np_stats = {k: np.asarray(v) for k, v in stats.items()}
    got = ops.qconv(torch.from_numpy(x), qt, stride=stride, padding=padding,
                    act_stats=np_stats)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    # the plain backend and the materializing oracle agree exactly
    plain = ops.qconv(torch.from_numpy(x), qt, stride=stride, padding=padding,
                      backend="torch", act_stats=np_stats)
    assert torch.equal(plain, got)
    oracle = ops._qconv_oracle(torch.from_numpy(x), qt,
                               {k: torch.tensor(float(v)) for k, v in np_stats.items()},
                               stride, padding)
    assert torch.equal(oracle, got)


@pytest.mark.parametrize("mode", MODES)
def test_conv2d_packed_fused_equals_unfused(mode):
    x, f, stride, padding = _data("3x3s1same_c8", seed=4)
    bias = torch.linspace(-1, 1, f.shape[-1])
    qt = tconv.pack_conv_filters(torch.from_numpy(f), QuantMode(mode), bias=bias)
    xt = torch.from_numpy(x)
    fused = tconv.conv2d_packed(xt, qt, stride=stride, padding=padding)
    unfused = tconv.conv2d_packed(xt, qt, stride=stride, padding=padding, fused=False)
    assert torch.equal(fused, unfused)


def test_geometry_helpers_match_jax():
    x, _, _, _ = _data("3x3s1same_c8")
    for kh, kw, stride, padding in [(3, 3, 1, "SAME"), (3, 3, 2, "VALID"),
                                    (5, 5, 2, "SAME"), (1, 1, 1, "SAME")]:
        assert conv_fused.conv_out_hw(7, 6, kh, kw, stride, padding) == \
            jcf.conv_out_hw(7, 6, kh, kw, stride, padding)
        geo = (kh, kw, 8, 4)
        assert conv_fused.conv_problem_dims(x.shape, geo, stride, padding) == \
            jcf.conv_problem_dims(x.shape, geo, stride, padding)
        assert conv_fused.im2col_hbm_bytes(x.shape, geo, stride, padding) == \
            jcf.im2col_hbm_bytes(x.shape, geo, stride, padding)
        got, dims = tconv.im2col(torch.from_numpy(x), kh, kw, stride, padding)
        ref, jdims = jconv.im2col(jnp.asarray(x), kh, kw, stride, padding)
        assert dims == jdims
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    xp, (oh, ow) = jcf.conv_spatial_pad(jnp.asarray(x), 3, 3, 1, "SAME")
    m = x.shape[0] * oh * ow
    for pid in (0, 1):
        ref = jcf.gather_patch_tile(xp, pid, block_m=64, m=m, oh=oh, ow=ow,
                                    stride=1, kh=3, kw=3)
        got = conv_fused.gather_patch_tile(torch.from_numpy(np.array(xp)), pid,
                                           block_m=64, m=m, oh=oh, ow=ow,
                                           stride=1, kh=3, kw=3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        for mode in MODES:
            np.testing.assert_array_equal(
                conv_fused.quantize_patch_values(got, QuantMode(mode), 0.3).numpy(),
                np.asarray(jcf.quantize_patch_values(ref, JMode(mode), 0.3)))


def test_check_conv_depth_matches_jax():
    for cin, k in [(128, 3), (3641, 3), (3640, 3)]:
        outcomes = []
        for fn in (jconv.check_conv_depth, tconv.check_conv_depth):
            try:
                fn(cin, k, k)
                outcomes.append("ok")
            except ValueError:
                outcomes.append("raised")
        assert outcomes[0] == outcomes[1]
