"""The port's QTensor against the JAX package's: packed planes, the
positional conv planes, the numpy loader, the legacy-dict round trip and
the accumulator guard.

Planes must be equal bit for bit.  The per-channel scales are float means
that torch reduces in another order than XLA: held to rtol 2**-20 (a few
float32 ULPs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.modes import QuantMode as JMode
from repro.kernels.qtensor import QTensor as JQTensor
from repro_torch import interop
from repro_torch.kernels import conv_fused
from repro_torch.kernels.modes import QuantMode
from repro_torch.kernels.qtensor import POS_PAYLOAD_KEYS, QTensor

STAT_RTOL = 2.0 ** -20
LOWBIT = ["tnn", "tbn", "bnn"]


def _weights(k, n, seed):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)


def _assert_same_planes(qt: QTensor, jqt: JQTensor):
    assert sorted(qt.payload) == sorted(jqt.payload)
    for key, ref in jqt.payload.items():
        got = qt.payload[key]
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(ref))


@pytest.mark.parametrize("mode", LOWBIT)
@pytest.mark.parametrize("per_channel", [True, False])
def test_from_dense_planes_match_jax(mode, per_channel):
    w = _weights(100, 12, 1)
    jqt = JQTensor.from_dense(jnp.asarray(w), JMode(mode), per_channel=per_channel)
    qt = QTensor.from_dense(torch.from_numpy(w), QuantMode(mode),
                            per_channel=per_channel)
    _assert_same_planes(qt, jqt)
    np.testing.assert_allclose(qt.scale.numpy(), np.asarray(jqt.scale),
                               rtol=STAT_RTOL)
    assert qt.shape == jqt.shape and qt.k_valid == 100
    assert qt.nbytes() == jqt.nbytes()
    np.testing.assert_allclose(qt.to_dense().numpy(), np.asarray(jqt.to_dense()),
                               rtol=STAT_RTOL)


@pytest.mark.parametrize("mode", LOWBIT)
@pytest.mark.parametrize("cin", [32, 8])
def test_conv_positional_planes_match_jax(mode, cin):
    geometry = (3, 3, cin, 6)
    w = _weights(9 * cin, 6, 2)
    jqt = JQTensor.from_dense(jnp.asarray(w), JMode(mode), geometry=geometry)
    qt = QTensor.from_dense(torch.from_numpy(w), QuantMode(mode),
                            geometry=geometry)
    _assert_same_planes(qt, jqt)                 # pos_* present iff cin % 32
    assert any(k in qt.payload for k in POS_PAYLOAD_KEYS[QuantMode(mode)]) == (cin % 32 != 0)
    # a legacy container (no positional planes) repacks to the same words
    legacy = QTensor.from_legacy_dict(qt.to_legacy_dict(), QuantMode(mode))
    for a, b in zip(conv_fused.conv_weight_planes(legacy),
                    conv_fused.conv_weight_planes(qt)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", LOWBIT)
def test_qtensor_from_numpy_round_trip(mode):
    w = _weights(70, 5, 3)
    bias = np.linspace(-1, 1, 5).astype(np.float32)
    jqt = JQTensor.from_dense(jnp.asarray(w), JMode(mode), bias=jnp.asarray(bias),
                              geometry=(1, 7, 10, 5))
    qt = interop.qtensor_from_numpy({k: np.asarray(v) for k, v in jqt.payload.items()},
                                    np.asarray(jqt.scale), np.asarray(jqt.bias),
                                    mode, jqt.shape, jqt.geometry, device="cpu")
    _assert_same_planes(qt, jqt)
    back = interop.qtensor_to_numpy(qt)
    for key, ref in jqt.payload.items():
        assert back["payload"][key].dtype == np.uint32
        np.testing.assert_array_equal(back["payload"][key], np.asarray(ref))
    np.testing.assert_array_equal(back["scale"], np.asarray(jqt.scale))
    np.testing.assert_array_equal(back["bias"], bias)
    assert (back["mode"], back["shape"], back["geometry"]) == (mode, (70, 5), (1, 7, 10, 5))
    again = interop.qtensor_from_numpy(**back, device="cpu")
    assert all(torch.equal(again.payload[k], qt.payload[k]) for k in qt.payload)


def test_legacy_dict_round_trip_and_to_device():
    qt = QTensor.from_dense(torch.from_numpy(_weights(40, 3, 4)), QuantMode.TNN,
                            bias=torch.ones(3))
    d = qt.to_legacy_dict()
    assert set(d) == {"plus", "minus", "scale", "b"}
    back = QTensor.from_legacy_dict(d, QuantMode.TNN, k_valid=40)
    assert back.shape == qt.shape and torch.equal(back.payload["plus"], qt.payload["plus"])
    with pytest.raises(ValueError, match="k_valid"):
        QTensor.from_legacy_dict(d, QuantMode.TNN)
    moved = qt.to("cpu")
    assert moved.device == torch.device("cpu") and torch.equal(moved.scale, qt.scale)


@pytest.mark.parametrize("mode", ["bnn", "tnn", "int8"])
def test_accumulator_guard_same_boundary(mode):
    from repro.kernels.modes import accumulator_bound
    bound = accumulator_bound(JMode(mode))
    ok = np.zeros((min(bound, 64), 2), np.float32)
    QTensor.from_dense(torch.from_numpy(ok), QuantMode(mode))
    # shape-only views: both guards fire before touching any value
    deep_np = np.broadcast_to(np.zeros((1, 2), np.float32), (bound + 1, 2))
    deep_t = torch.zeros(1, 2).expand(bound + 1, 2)
    with pytest.raises(ValueError, match="accumulator bound"):
        JQTensor.from_dense(deep_np, JMode(mode))
    with pytest.raises(ValueError, match="accumulator bound"):
        QTensor.from_dense(deep_t, QuantMode(mode))
    edge_np = np.broadcast_to(np.zeros((1, 1), np.float32), (bound, 1))
    if mode == "int8":       # at the bound both accept (int8 grid is cheap)
        JQTensor.from_dense(jnp.asarray(edge_np), JMode(mode))
        QTensor.from_dense(torch.zeros(1, 1).expand(bound, 1), QuantMode(mode))
