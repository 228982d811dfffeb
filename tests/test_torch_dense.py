"""The port's dense backend against the JAX package's, on the CPU.

* ``dense_matmul_fused_torch`` against ``dense_matmul_fused_pallas``
  (interpret mode, as the reference's tests run it): ``array_equal``
  without bias; with bias within one float32 ULP of the largest pre-bias
  value (XLA may contract the reference's last multiply and the add into
  one FMA; the port never does).  Ragged depths (k % 32 != 0) included,
  which is where BNN's pad bits would decode to +1;
* the port's dense backend against its popcount backend: ``qmm`` and the
  unfused oracle cell, ``array_equal``;
* ``dense_conv_fused_torch`` against ``dense_conv_fused_pallas`` with the
  JAX ``conv_act_stats`` injected, every mode x {3x3 s1 SAME Cin=32,
  Cin=8 (positional planes), s2 VALID}: ``array_equal``; and
  ``qconv(backend="dense")`` == ``qconv(backend="torch")`` in the port;
* ``PaperCNN(PAPER_CNN_SMOKE, backend="dense")`` == the popcount run,
  layer by layer and in the logits;
* the registry: the new cells are listed, and ``modes()`` / ``backends()``
  agree with the reference's under the backend mapping;
* the dense GeMM wrapper with one per-tensor activation scale (one value
  or expanded to (m, 1)), and its operand checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conv as jconv
from repro.core import encoding as jenc
from repro.kernels import conv_fused as jcf
from repro.kernels import registry as jregistry
from repro.kernels.dense_fused import dense_conv_fused_pallas, dense_matmul_fused_pallas
from repro.kernels.modes import QuantMode as JMode
from repro_torch import interop
from repro_torch.cnn import PaperCNN
from repro_torch.configs.paper_cnn import PAPER_CNN_SMOKE
from repro_torch.kernels import _build, conv_fused, dense_fused, ops, registry
from repro_torch.kernels.modes import QuantMode

MODES = ["tnn", "tbn", "bnn"]
CONV_CASES = {
    # name: (x shape, filter shape, stride, padding)
    "3x3s1same_c32": ((2, 6, 6, 32), (3, 3, 32, 9), 1, "SAME"),
    "3x3s1same_c8": ((2, 7, 6, 8), (3, 3, 8, 5), 1, "SAME"),
    "3x3s2valid": ((1, 9, 11, 40), (3, 3, 40, 7), 2, "VALID"),
}
# port backend -> reference backend
BACKEND_MAP = {"cuda": "pallas", "torch": "xla", "dense": "dense"}


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32 else a).copy())


def _operands(mode, m, n, k, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-1, 2, (m, k)).astype(np.float32)
    b = rng.integers(-1, 2, (n, k)).astype(np.float32)
    pack_a = jenc.pack_binary if mode == "bnn" else jenc.pack_ternary
    pack_b = jenc.pack_ternary if mode == "tnn" else jenc.pack_binary

    def planes(pack, v):
        out = pack(jnp.asarray(v))
        return [np.asarray(p) for p in (out if isinstance(out, tuple) else (out,))]

    row = rng.uniform(0.5, 2, (m, 1)).astype(np.float32)
    col = rng.uniform(0.5, 2, (1, n)).astype(np.float32)
    bias = rng.standard_normal((1, n)).astype(np.float32)
    return planes(pack_a, a), planes(pack_b, b), row, col, bias


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(37, 21, 130), (6, 5, 33)])
def test_dense_gemm_plain_matches_pallas(mode, shape):
    m, n, k = shape
    a_pl, b_pl, row, col, bias = _operands(mode, m, n, k, seed=sum(shape))
    ja, jb = tuple(jnp.asarray(p) for p in a_pl), tuple(jnp.asarray(p) for p in b_pl)
    ta, tb = [_t(p) for p in a_pl], [_t(p) for p in b_pl]
    qm = QuantMode(mode)
    ref = np.asarray(dense_matmul_fused_pallas(JMode(mode), ja, jb, k, jnp.asarray(row),
                                               jnp.asarray(col), None, interpret=True))
    got = dense_fused.dense_matmul_fused_torch(qm, ta, tb, k, _t(row), _t(col))
    np.testing.assert_array_equal(got.numpy(), ref)
    # the registered "dense" entry on CPU tensors is the plain version
    _build.reset_launches()
    cell = registry.lookup(qm, "dense", fused=True)
    assert torch.equal(cell.fn(ta, tb, k, _t(row), _t(col), None), got)
    assert _build.launches() == {}
    ref = np.asarray(dense_matmul_fused_pallas(JMode(mode), ja, jb, k, jnp.asarray(row),
                                               jnp.asarray(col), jnp.asarray(bias),
                                               interpret=True))
    one_ulp = np.finfo(np.float32).eps * np.abs(ref - bias).max()
    np.testing.assert_allclose(
        dense_fused.dense_matmul_fused_torch(qm, ta, tb, k, _t(row), _t(col), _t(bias)).numpy(),
        ref, rtol=0, atol=one_ulp)


@pytest.mark.parametrize("mode", MODES)
def test_dense_backend_equals_popcount(mode):
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((29, 97)).astype(np.float32))
    qt = ops.pack_weights(torch.from_numpy(rng.standard_normal((97, 13)).astype(np.float32)),
                          QuantMode(mode))
    qt = qt.replace(bias=torch.linspace(-1, 1, 13))
    popcount = ops.qmm(x, qt, backend="torch")
    assert torch.equal(ops.qmm(x, qt, backend="dense"), popcount)
    assert torch.equal(ops._qmm_oracle(x, qt), popcount)
    xa = ops.quantize_activations(x, QuantMode(mode))
    assert torch.equal(ops.packed_matmul(xa, qt, backend="dense"),
                       ops.packed_matmul(xa, qt, backend="torch"))


def test_bnn_ragged_depths_mask_pad_bits():
    """BNN pad bits decode to +1 on both operands; k one past a word
    boundary maximizes the pad run."""
    rng = np.random.default_rng(8)
    for k in (1, 31, 33, 65):
        a = torch.from_numpy(np.where(rng.random((6, k)) < 0.5, -1.0, 1.0).astype(np.float32))
        b = torch.from_numpy(np.where(rng.random((k, 5)) < 0.5, -1.0, 1.0).astype(np.float32))
        want = (a.double() @ b.double()).to(torch.int32)
        assert torch.equal(ops.lowbit_matmul(a, b, QuantMode.BNN, backend="dense"), want)
        assert torch.equal(ops.lowbit_matmul(a, b, QuantMode.BNN), want)


def _conv_data(case, seed):
    xs, fs, stride, padding = CONV_CASES[case]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(xs).astype(np.float32),
            rng.standard_normal(fs).astype(np.float32), stride, padding)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_dense_conv_plain_matches_pallas(mode, case):
    x, f, stride, padding = _conv_data(case, seed=6)
    kh, kw = f.shape[:2]
    jqt = jconv.pack_conv_filters(jnp.asarray(f), JMode(mode))
    stats = jcf.conv_act_stats(jnp.asarray(x), JMode(mode), kh, kw, stride, padding)
    ref = np.asarray(dense_conv_fused_pallas(
        JMode(mode), jnp.asarray(x), jcf.conv_weight_planes(jqt), jqt.geometry, stride,
        padding, stats, jnp.asarray(jqt.scale).reshape(1, -1), None, interpret=True))
    qt = interop.qtensor_from_numpy({k: np.asarray(v) for k, v in jqt.payload.items()},
                                    np.asarray(jqt.scale), None, mode, jqt.shape,
                                    jqt.geometry, device="cpu")
    tstats = {k: torch.tensor(float(v)) for k, v in stats.items()}
    got = dense_fused.dense_conv_fused_torch(
        QuantMode(mode), torch.from_numpy(x), conv_fused.conv_weight_planes(qt), qt.geometry,
        stride, padding, tstats, qt.scale.reshape(1, -1))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    # qconv through the dense cell == the popcount plain backend, with and
    # without bias
    for bias in (None, torch.linspace(-1, 1, f.shape[-1])):
        qb = qt.replace(bias=bias)
        dense = ops.qconv(torch.from_numpy(x), qb, stride=stride, padding=padding,
                          backend="dense", act_stats=tstats)
        assert torch.equal(dense, ops.qconv(torch.from_numpy(x), qb, stride=stride,
                                            padding=padding, backend="torch",
                                            act_stats=tstats))


def test_paper_cnn_dense_equals_popcount_on_cpu():
    dense = PaperCNN(PAPER_CNN_SMOKE, seed=6, device="cpu", backend="dense")
    plain = PaperCNN(PAPER_CNN_SMOKE, seed=6, device="cpu", backend="torch")
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3, 8, 8, 3)).astype(np.float32))
    h_d = h_p = x
    for spec, ld, lp in zip(PAPER_CNN_SMOKE.convs, dense.layers, plain.layers):
        h_d, h_p = torch.relu(ld(h_d)), torch.relu(lp(h_p))
        assert torch.equal(h_d, h_p), spec
        if spec.pool:
            b, hh, ww, c = h_d.shape
            h_d = h_d.reshape(b, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))
            h_p = h_p.reshape(b, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))
    assert torch.equal(dense(x), plain(x))


def test_registry_lists_new_cells_and_matches_reference():
    import repro.kernels.ops  # noqa: F401  (registers the reference's kernels)

    table = registry.capability_table()
    for text in ("csrc/dense_tc.cu", "csrc/affine_gemm.cu", "materializing oracle"):
        assert text in table
    for mode in MODES:
        qm = QuantMode(mode)
        assert registry.has(qm, "dense", fused=True)
        assert registry.has(qm, "dense", fused=False)
        assert ops.has_conv_kernel(qm, "dense")
    ported = set(BACKEND_MAP.values())
    for backend, ref_backend in BACKEND_MAP.items():
        assert [m.value for m in registry.modes(backend)] == \
            [m.value for m in jregistry.modes(ref_backend)]
    for mode in registry.modes():
        got = sorted(BACKEND_MAP[b] for b in registry.backends(mode))
        want = [b for b in jregistry.backends(JMode(mode.value)) if b in ported]
        assert got == want, mode
    # the cells themselves, under the mapping (fused, layout)
    for spec in registry.available():
        assert jregistry.has(JMode(spec.mode.value), BACKEND_MAP[spec.backend],
                             fused=spec.fused, layout=spec.layout), spec.key


@pytest.mark.parametrize("mode", MODES)
def test_dense_wrapper_takes_one_row_scale_and_checks_operands(mode):
    """One per-tensor activation scale, as one value or expanded to (m, 1),
    gives the output of that scale copied to every row; a mix of CPU and
    CUDA operands, a wrong plane count or dtype raises."""
    from repro_torch.kernels._matmul_common import gemm_dims

    m, n, k = 29, 13, 97
    a_pl, b_pl, row, col, bias = _operands(mode, m, n, k, seed=12)
    ta, tb = [_t(p) for p in a_pl], [_t(p) for p in b_pl]
    qm = QuantMode(mode)
    one = _t(row)[:1]
    want = dense_fused.dense_matmul_fused_cuda(qm, ta, tb, k, one.expand(m, 1).contiguous(),
                                               _t(col), _t(bias))
    for r in (one, one.expand(m, 1)):
        assert torch.equal(dense_fused.dense_matmul_fused_cuda(qm, ta, tb, k, r, _t(col),
                                                               _t(bias)), want)

    class OnCard:
        is_cuda = True

    with pytest.raises(ValueError, match="mix"):
        dense_fused.dense_matmul_fused_cuda(qm, ta, tb, k, one, _t(col), OnCard())
    with pytest.raises(ValueError, match="planes"):
        gemm_dims(qm, ta + ta, tb)
    with pytest.raises(TypeError, match="int32"):
        gemm_dims(qm, [p.float() for p in ta], tb)
