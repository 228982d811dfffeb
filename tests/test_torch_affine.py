"""The port's u8/u4 baselines and float passthrough against the JAX package,
on the CPU.

* the plain raw accumulators against ``int8_matmul_pallas`` /
  ``int4_matmul_pallas`` (interpret mode), operands with values 128..255
  present and an odd depth for u4: ``array_equal``;
* the nibble packers against the JAX ones, bit for bit;
* ``int8_affine_matmul`` / ``int4_affine_matmul`` against
  ``repro.kernels.ops`` and the exact ``(a - za) @ (b - zb)``:
  ``array_equal``;
* ``qmm`` on INT8/INT4 QTensors loaded through ``interop`` from the JAX
  QTensor's leaves against ``repro.kernels.ops``: the activation grid,
  scale and zero and the int32 core ``array_equal``; the fused output
  against the reference's fused cells fed the same statistics
  ``array_equal`` without bias and within one float32 ULP of the largest
  pre-bias value with it (XLA may contract the last multiply and the add
  into an FMA); against the jitted ``jops.qmm`` within 2 ULPs per element
  (XLA computes the scale's division by qmax as a reciprocal multiply
  under ``jit``, one ULP from the eager division both packages make);
* the f32 passthrough against ``jops.qmm``: ``allclose`` at rtol 1e-6
  (atol 1e-6 of the largest output: float32 dots sum in another order);
  bf16 within the float32 summation bound ``k * 2**-24 * (|x| @ |w|)`` of
  the bf16-rounded operands, whose products are exact in float32;
* ``interop`` round trips of INT8/INT4/F32/BF16 QTensors;
* the kernel's launch plan: the CTA tile (32 at the GEMM_GRID diagonal,
  64 at the CNN's im2col GeMMs at batch 256 on 132 SMs; the largest tile
  whose grid covers every SM; 64 on one SM) and the operand checks of
  ``affine_gemm_call``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.int4_matmul import int4_matmul_pallas
from repro.kernels.int4_matmul import pack_nibbles_cols as jpack_cols
from repro.kernels.int4_matmul import pack_nibbles_rows as jpack_rows
from repro.kernels.int8_matmul import int8_matmul_pallas
from repro.kernels.modes import QuantMode as JMode
from repro_torch import interop
from repro_torch.kernels import _build, int4_matmul, int8_matmul, ops, registry
from repro_torch.kernels.modes import QuantMode

AFFINE = ["int8", "int4"]


def _qtensor(jqt):
    return interop.qtensor_from_numpy(
        {k: np.asarray(v) for k, v in jqt.payload.items()},
        None if jqt.scale is None else np.asarray(jqt.scale),
        None if jqt.bias is None else np.asarray(jqt.bias), jqt.mode.value, jqt.shape,
        zero=None if jqt.zero is None else np.asarray(jqt.zero), device="cpu")


# ragged shapes beside the two first: k % 16 != 0, n % 4 != 0 with
# n % 16 != 0, m below a 32 tile
@pytest.mark.parametrize("shape", [(13, 9, 70), (40, 33, 256), (20, 16, 200), (9, 30, 48),
                                   (3, 7, 33)])
def test_int8_plain_matches_pallas(shape):
    m, n, k = shape
    rng = np.random.default_rng(k)
    a = rng.integers(0, 256, (m, k)).astype(np.uint8)
    b = rng.integers(0, 256, (k, n)).astype(np.uint8)
    assert a.max() >= 128 and b.max() >= 128
    ref = np.asarray(int8_matmul_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = int8_matmul.int8_matmul_torch(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    _build.reset_launches()
    assert torch.equal(int8_matmul.int8_matmul_cuda(torch.from_numpy(a),
                                                    torch.from_numpy(b)), got)
    assert _build.launches() == {}


# odd logical depths (71, 77, 33: a zero nibble pads both sides), n % 4 != 0,
# m below a 32 tile
@pytest.mark.parametrize("shape", [(13, 9, 71), (8, 20, 64), (20, 30, 77), (3, 7, 33)])
def test_int4_plain_and_packers_match_jax(shape):
    m, n, k = shape
    rng = np.random.default_rng(k)
    a = rng.integers(0, 16, (m, k)).astype(np.uint8)
    b = rng.integers(0, 16, (k, n)).astype(np.uint8)
    ja, jb = jpack_rows(jnp.asarray(a)), jpack_cols(jnp.asarray(b))
    pa = int4_matmul.pack_nibbles_rows(torch.from_numpy(a))
    pb = int4_matmul.pack_nibbles_cols(torch.from_numpy(b))
    assert pa.dtype == pb.dtype == torch.uint8
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    ref = np.asarray(int4_matmul_pallas(ja, jb, interpret=True))
    np.testing.assert_array_equal(int4_matmul.int4_matmul_torch(pa, pb).numpy(), ref)
    np.testing.assert_array_equal(int4_matmul.int4_matmul_cuda(pa, pb).numpy(), ref)


@pytest.mark.parametrize("mode", AFFINE)
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_affine_matmul_matches_jax(mode, backend):
    top = 256 if mode == "int8" else 16
    rng = np.random.default_rng(top)
    m, n, k = 12, 10, 65
    aq = rng.integers(0, top, (m, k)).astype(np.int32)
    bq = rng.integers(0, top, (k, n)).astype(np.int32)
    za, zb = int(rng.integers(0, top)), int(rng.integers(0, top))
    jfn = jops.int8_affine_matmul if mode == "int8" else jops.int4_affine_matmul
    tfn = ops.int8_affine_matmul if mode == "int8" else ops.int4_affine_matmul
    ref = np.asarray(jfn(jnp.asarray(aq), jnp.asarray(bq), za, zb, k,
                         backend={"cuda": "pallas", "torch": "xla"}[backend]))
    got = tfn(torch.from_numpy(aq), torch.from_numpy(bq), torch.tensor(za, dtype=torch.int32),
              zb, k, backend=backend)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), (aq.astype(np.int64) - za) @ (bq - zb))


@pytest.mark.parametrize("mode", AFFINE)
@pytest.mark.parametrize("with_bias", [False, True])
def test_affine_qmm_matches_jax(mode, with_bias):
    rng = np.random.default_rng(31)
    m, k, n = 17, 90, 11
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) if with_bias else None
    jqt = jops.pack_weights(jnp.asarray(w), JMode(mode))
    if with_bias:
        jqt = jqt.replace(bias=jnp.asarray(bias))
    qt = _qtensor(jqt)
    # the activation grid and the int32 core
    jxa = jops.quantize_activations(jnp.asarray(x), JMode(mode))
    txa = ops.quantize_activations(torch.from_numpy(x), QuantMode(mode))
    for key in ("q", "scale", "zero"):
        np.testing.assert_array_equal(txa[key].numpy(), np.asarray(jxa[key]))
    core = registry.lookup(QuantMode(mode), "cuda", fused=False)
    acc = core.fn((txa["q"], txa["zero"]), ops._b_planes(qt, QuantMode(mode)), k)
    ref_acc = jops.registry.lookup(JMode(mode), "pallas", fused=False).fn(
        (jxa["q"], jxa["zero"]), jops._b_planes(jqt, JMode(mode)), k, interpret=True)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref_acc))
    # the fused output against the reference's fused cells fed the same
    # (eager) statistics, through both reference backends and both of the
    # port's
    r = jops._as_row_scale(jxa["scale"], m)
    c = jops._as_col_vec(jqt.scale, n)
    b2 = None if jqt.bias is None else jops._as_col_vec(jqt.bias, n)
    for jb in ("pallas", "xla"):
        ref = np.asarray(jops.registry.lookup(JMode(mode), jb, fused=True).fn(
            (jxa["q"], jxa["zero"]), jops._b_planes(jqt, JMode(mode)), k, r, c, b2,
            interpret=True))
        for tb in ("cuda", "torch"):
            got = ops.qmm(torch.from_numpy(x), qt, backend=tb).numpy()
            if with_bias:
                one_ulp = np.finfo(np.float32).eps * np.abs(ref - bias).max()
                np.testing.assert_allclose(got, ref, rtol=0, atol=one_ulp)
            else:
                np.testing.assert_array_equal(got, ref)
    # jops.qmm itself runs under jax.jit, where XLA replaces the division
    # by qmax in affine_calibrate with a reciprocal multiply: its
    # activation scale may sit one ULP from the eager one, so its output
    # within 2 ULPs of each element (plus the bias path's one ULP)
    ref = np.asarray(jops.qmm(jnp.asarray(x), jqt, backend="xla"))
    pre = np.abs(ref - (0 if bias is None else bias))
    np.testing.assert_array_less(np.abs(got - ref),
                                 np.finfo(np.float32).eps * (2 * pre + pre.max()) + 1e-30)


def test_affine_backend_falls_back_to_the_card_default():
    assert ops._affine_backend(QuantMode.INT8, "dense", fused=True) == "cuda"
    assert ops._affine_backend(QuantMode.INT4, "torch", fused=False) == "torch"
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((5, 20)).astype(np.float32))
    qt = ops.pack_weights(torch.from_numpy(rng.standard_normal((20, 3)).astype(np.float32)),
                          QuantMode.INT8)
    assert torch.equal(ops.qmm(x, qt, backend="dense"), ops.qmm(x, qt))


def test_f32_passthrough_matches_jax():
    rng = np.random.default_rng(41)
    x = rng.standard_normal((19, 48)).astype(np.float32)
    w = rng.standard_normal((48, 13)).astype(np.float32)
    bias = rng.standard_normal(13).astype(np.float32)
    jqt = jops.pack_weights(jnp.asarray(w), JMode.F32).replace(bias=jnp.asarray(bias))
    ref = np.asarray(jops.qmm(jnp.asarray(x), jqt))
    got = ops.qmm(torch.from_numpy(x), _qtensor(jqt))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_bf16_passthrough_matches_jax():
    rng = np.random.default_rng(43)
    k = 64
    x = rng.standard_normal((9, k)).astype(np.float32)
    w = rng.standard_normal((k, 7)).astype(np.float32)
    jqt = jops.pack_weights(jnp.asarray(w), JMode.BF16)
    ref = np.asarray(jops.qmm(jnp.asarray(x), jqt))
    got = ops.qmm(torch.from_numpy(x), _qtensor(jqt))
    assert got.dtype == torch.float32
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    wb = np.asarray(jqt.payload["w"].astype(jnp.float32))
    bound = k * 2.0 ** -24 * (np.abs(xb) @ np.abs(wb))
    assert (np.abs(got.numpy() - ref) <= bound).all()


@pytest.mark.parametrize("mode", ["int8", "int4", "f32", "bf16"])
def test_interop_round_trip_affine_and_float(mode):
    rng = np.random.default_rng(51)
    w = rng.standard_normal((30, 6)).astype(np.float32)
    bias = np.linspace(-1, 1, 6).astype(np.float32)
    jqt = jops.pack_weights(jnp.asarray(w), JMode(mode)).replace(bias=jnp.asarray(bias))
    qt = _qtensor(jqt)
    assert qt.layout == jqt.layout and qt.shape == jqt.shape
    back = interop.qtensor_to_numpy(qt)
    for key, ref in jqt.payload.items():
        np.testing.assert_array_equal(back["payload"][key],
                                      np.asarray(ref).astype(back["payload"][key].dtype))
    for key in ("scale", "zero"):
        ref = getattr(jqt, key)
        if ref is None:
            assert back[key] is None
        else:
            np.testing.assert_array_equal(back[key], np.asarray(ref))
    np.testing.assert_array_equal(back["bias"], bias)
    again = interop.qtensor_from_numpy(**back, device="cpu")
    assert again.layout == qt.layout
    assert all(torch.equal(again.payload[k], qt.payload[k]) for k in qt.payload)
    np.testing.assert_array_equal(interop.qtensor_to_numpy(again)["payload"]["q" if mode
                                  in ("int8", "int4") else "w"],
                                  back["payload"]["q" if mode in ("int8", "int4") else "w"])


GEMM_GRID_DIAGONAL = [(72, 24), (120, 48), (240, 72), (360, 96)]
CNN_IM2COL_BATCH256 = [(262144, 64), (65536, 128), (16384, 256)]


@pytest.mark.parametrize("mn", GEMM_GRID_DIAGONAL + CNN_IM2COL_BATCH256)
def test_affine_tile_plan(mn):
    from repro_torch.kernels._matmul_common import AFFINE_TILES, gemm_tile

    m, n = mn
    tile = gemm_tile(m, n, 132, AFFINE_TILES)
    # the diagonal's 64x64 grids have 2-12 blocks for 132 SMs, its 32x32
    # grids 3-36: the smaller tile; the CNN's im2col GeMMs fill the card
    # with the larger
    assert tile == (32 if mn in GEMM_GRID_DIAGONAL else 64)
    covers = [t for t in AFFINE_TILES if -(-m // t) * -(-n // t) >= 132]
    assert tile == (covers[0] if covers else AFFINE_TILES[-1])
    assert gemm_tile(m, n, 1, AFFINE_TILES) == 64


def test_affine_call_raises_on_bad_operands():
    a = torch.zeros((4, 8), dtype=torch.uint8)
    b = torch.zeros((8, 3), dtype=torch.uint8)
    call = int8_matmul.affine_gemm_call
    with pytest.raises(TypeError, match="uint8"):
        call(False, a.to(torch.int8), b, 8)
    with pytest.raises(TypeError, match="contiguous"):
        call(False, a, b.t().contiguous().t(), 8)
    with pytest.raises(TypeError, match="2-D"):
        call(False, a.reshape(-1), b, 8)
    with pytest.raises(ValueError, match="CUDA"):
        call(False, a, b, 8)
    _build.reset_launches()
    assert torch.equal(int4_matmul.int4_matmul_cuda(a, b), int4_matmul.int4_matmul_torch(a, b))
    assert _build.launches() == {}
