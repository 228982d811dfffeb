"""The port's low-bit GeMM against the JAX package.

* the plain TNN/TBN/BNN versions, int32 and fused, against the reference
  Pallas kernels (interpret mode, as the reference's tests run them) and
  the reference XLA versions: ``array_equal`` for the int32 core and the
  no-bias fused output; the bias path within one float32 ULP of the
  largest pre-bias value (XLA may contract the reference's last multiply
  and the add into one FMA; the port never does);
* ``qmm`` / ``packed_matmul`` against ``repro.kernels.ops`` with the JAX
  activation statistics injected: ``array_equal``;
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.kernels import ops as jops
from repro.kernels.bnn_matmul import bnn_matmul_fused_pallas, bnn_matmul_pallas
from repro.kernels.modes import QuantMode as JMode
from repro.kernels.tbn_matmul import tbn_matmul_fused_pallas, tbn_matmul_pallas
from repro.kernels.tnn_matmul import tnn_matmul_fused_pallas, tnn_matmul_pallas
from repro_torch import interop
from repro_torch.kernels import _build, ops, registry
from repro_torch.kernels import bnn_matmul, tbn_matmul, tnn_matmul
from repro_torch.kernels.modes import QuantMode

MODES = ["tnn", "tbn", "bnn"]

JAX_PALLAS = {"tnn": (tnn_matmul_pallas, tnn_matmul_fused_pallas),
              "tbn": (tbn_matmul_pallas, tbn_matmul_fused_pallas),
              "bnn": (bnn_matmul_pallas, bnn_matmul_fused_pallas)}
JAX_XLA = {"tnn": (jops.tnn_matmul_xla, jops.tnn_matmul_xla_fused),
           "tbn": (jops.tbn_matmul_xla, jops.tbn_matmul_xla_fused),
           "bnn": (jops.bnn_matmul_xla, jops.bnn_matmul_xla_fused)}
PORT_PLAIN = {"tnn": (tnn_matmul.tnn_matmul_torch, tnn_matmul.tnn_matmul_fused_torch),
              "tbn": (tbn_matmul.tbn_matmul_torch, tbn_matmul.tbn_matmul_fused_torch),
              "bnn": (bnn_matmul.bnn_matmul_torch, bnn_matmul.bnn_matmul_fused_torch)}
PORT_CUDA = {"tnn": (tnn_matmul.tnn_matmul_cuda, tnn_matmul.tnn_matmul_fused_cuda),
             "tbn": (tbn_matmul.tbn_matmul_cuda, tbn_matmul.tbn_matmul_fused_cuda),
             "bnn": (bnn_matmul.bnn_matmul_cuda, bnn_matmul.bnn_matmul_fused_cuda)}


def _operands(mode, m, n, k, seed):
    """Valid packed planes (uint32 numpy) of random ±1/0 matrices, plus
    epilogue vectors."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-1, 2, (m, k)).astype(np.float32)
    b = rng.integers(-1, 2, (n, k)).astype(np.float32)
    if mode == "bnn":
        a_pl = [np.asarray(jenc.pack_binary(jnp.asarray(a)))]
    else:
        a_pl = [np.asarray(p) for p in jenc.pack_ternary(jnp.asarray(a))]
    if mode == "tnn":
        b_pl = [np.asarray(p) for p in jenc.pack_ternary(jnp.asarray(b))]
    else:
        b_pl = [np.asarray(jenc.pack_binary(jnp.asarray(b)))]
    row = rng.uniform(0.5, 2, (m, 1)).astype(np.float32)
    col = rng.uniform(0.5, 2, (1, n)).astype(np.float32)
    bias = rng.standard_normal((1, n)).astype(np.float32)
    return a_pl, b_pl, row, col, bias


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32 else a).copy())


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas(mode):
    m, n, k = 37, 21, 130                                   # ragged everywhere
    a_pl, b_pl, row, col, bias = _operands(mode, m, n, k, seed=1)
    j_int, j_fused = JAX_PALLAS[mode]
    p_int, p_fused = PORT_PLAIN[mode]
    ja = [jnp.asarray(p) for p in a_pl + b_pl]
    ta = [_t(p) for p in a_pl + b_pl]
    ref = np.asarray(j_int(*ja, k, interpret=True))
    got = p_int(*ta, k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    ref = np.asarray(j_fused(*ja, k, jnp.asarray(row), jnp.asarray(col), None,
                             interpret=True))
    np.testing.assert_array_equal(p_fused(*ta, k, _t(row), _t(col)).numpy(), ref)
    ref = np.asarray(j_fused(*ja, k, jnp.asarray(row), jnp.asarray(col),
                             jnp.asarray(bias), interpret=True))
    one_ulp = np.finfo(np.float32).eps * np.abs(ref - bias).max()
    np.testing.assert_allclose(p_fused(*ta, k, _t(row), _t(col), _t(bias)).numpy(),
                               ref, rtol=0, atol=one_ulp)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(72, 24, 128), (5, 3, 1), (64, 64, 33 * 32)])
def test_plain_matches_xla(mode, shape):
    m, n, k = shape
    a_pl, b_pl, row, col, _ = _operands(mode, m, n, k, seed=sum(shape))
    j_int, j_fused = JAX_XLA[mode]
    ja = [jnp.asarray(p) for p in a_pl + b_pl]
    ta = [_t(p) for p in a_pl + b_pl]
    p_int, p_fused = PORT_PLAIN[mode]
    np.testing.assert_array_equal(p_int(*ta, k, word_chunk=3).numpy(),
                                  np.asarray(j_int(*ja, k)))
    # the "cuda" entry on CPU tensors is the plain version
    c_int, c_fused = PORT_CUDA[mode]
    np.testing.assert_array_equal(
        c_fused(*ta, k, _t(row), _t(col)).numpy(),
        np.asarray(j_fused(*ja, k, jnp.asarray(row), jnp.asarray(col))))
    assert torch.equal(c_int(*ta, k), p_int(*ta, k))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_qmm_matches_jax_with_injected_stats(mode, backend):
    rng = np.random.default_rng(11)
    m, k, n = 45, 200, 19
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jqt = jops.pack_weights(jnp.asarray(w), JMode(mode))
    xa = jops.quantize_activations(jnp.asarray(x), JMode(mode))
    stats = {kk: np.asarray(xa[kk]) for kk in ("thr", "scale") if kk in xa}
    if mode != "bnn":
        from repro.core import quantize as jq
        stats["thr"] = np.asarray(jq.ternary_threshold(jnp.asarray(x)))
    ref = np.asarray(jops.qmm(jnp.asarray(x), jqt, backend=backend,
                              act_stats={kk: jnp.asarray(v) for kk, v in stats.items()}))
    qt = interop.qtensor_from_numpy({kk: np.asarray(v) for kk, v in jqt.payload.items()},
                                    np.asarray(jqt.scale), None, mode, jqt.shape,
                                    device="cpu")
    got = ops.qmm(torch.from_numpy(x), qt, act_stats=stats)
    np.testing.assert_array_equal(got.numpy(), ref)
    # packed_matmul: the int32 core on the same planes
    txa = ops.quantize_activations(torch.from_numpy(x), QuantMode(mode), stats=stats)
    ref_i = np.asarray(jops.packed_matmul(
        jops.quantize_activations(jnp.asarray(x), JMode(mode)), jqt, backend="xla"))
    np.testing.assert_array_equal(ops.packed_matmul(txa, qt).numpy(), ref_i)
    np.testing.assert_array_equal(ops.packed_matmul(txa, qt, backend="torch").numpy(),
                                  ref_i)


@pytest.mark.parametrize("mode", MODES)
def test_qmm_own_stats_and_oracle(mode):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((33, 70)).astype(np.float32))
    qt = ops.pack_weights(torch.from_numpy(rng.standard_normal((70, 9)).astype(np.float32)),
                          QuantMode(mode))
    y = ops.qmm(x, qt)
    assert torch.equal(y, ops._qmm_oracle(x, qt))
    assert torch.equal(y, ops.qmm(x, qt, backend="torch"))
    with pytest.raises(ValueError, match="depth mismatch"):
        ops.qmm(x[:, :-1], qt)


@pytest.mark.parametrize("mode", MODES)
def test_ref_oracles_match_jax(mode):
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref

    m, n, k = 9, 7, 70
    a_pl, b_pl, _, _, _ = _operands(mode, m, n, k, seed=3)
    ja = [jnp.asarray(p) for p in a_pl + b_pl]
    ta = [_t(p) for p in a_pl + b_pl]
    got = getattr(tref, f"{mode}_matmul_ref")(*ta, k)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(getattr(jref, f"{mode}_matmul_ref")(*ja, k)))
    rng = np.random.default_rng(4)
    a = rng.integers(-1, 2, (m, k)).astype(np.float32)
    b = rng.integers(-1, 2, (k, n)).astype(np.float32)
    dense = getattr(tref, f"{mode}_matmul_dense_ref")(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(dense.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    for name, top in (("int8_matmul_ref", 256), ("int4_matmul_ref", 16)):
        aq = rng.integers(0, top, (m, k), dtype=np.int32)
        bq = rng.integers(0, top, (k, n), dtype=np.int32)
        ref = getattr(jref, name)(jnp.asarray(aq), jnp.asarray(bq), 3, 5, k)
        got = getattr(tref, name)(torch.from_numpy(aq), torch.from_numpy(bq), 3, 5, k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_registry_cells():
    for mode in QuantMode:
        if not mode.is_lowbit:
            continue
        for backend in ("cuda", "torch"):
            for fused in (False, True):
                assert registry.has(mode, backend, fused=fused)
            assert ops.has_conv_kernel(mode, backend)
    assert "cuda-popcount" in registry.capability_table()
    with pytest.raises(KeyError, match="registered"):
        registry.lookup(QuantMode.TNN, "pallas", fused=True)
    f32 = ops.QTensor.from_dense(torch.ones(4, 2), QuantMode.F32)
    with pytest.raises(ValueError, match="not ported"):
        ops.qmm(torch.ones(3, 4), f32)


def test_cpu_operands_never_launch():
    _build.reset_launches()
    a_pl, b_pl, row, col, _ = _operands("tnn", 8, 8, 40, seed=2)
    tnn_matmul.tnn_matmul_fused_cuda(*[_t(p) for p in a_pl + b_pl], 40, _t(row), _t(col))
    assert _build.launches() == {}
    with pytest.raises(ValueError, match="CUDA"):
        from repro_torch.kernels._matmul_common import lowbit_matmul_call
        lowbit_matmul_call(QuantMode.TNN, [_t(p) for p in a_pl], [_t(p) for p in b_pl], 40)
