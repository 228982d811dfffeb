"""The port's indexed (RSR) backend (``repro_torch.kernels.indexed_matmul``)
against the JAX package's (``repro.kernels.indexed_matmul``) and against
the port's popcount path, on the CPU.

Bounds: none but equality.  The integer cores are ``array_equal``; the
fused outputs are ``array_equal`` too, because both sides apply eq. (2)
to the same integers with the same scales in the same multiply order.
Where the reference is compared through ``qmm``, the weights are the
reference's packed containers (``interop.qtensor_from_numpy``) and the
activation statistics the reference's own (``act_stats=``), so no float
reduction of one framework meets one of the other.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.kernels import ops as jops
from repro.kernels import registry as jregistry
from repro_torch import interop
from repro_torch.core import encoding
from repro_torch.core.policy import POLICIES
from repro_torch.kernels import ops, registry
from repro_torch.kernels import indexed_matmul as ixm
from repro_torch.kernels._matmul_common import TileConfig
from repro_torch.kernels.modes import QuantMode
from repro_torch.kernels.qtensor import QTensor

jixm = importlib.import_module("repro.kernels.indexed_matmul")
from repro.kernels.ops import QuantMode as JMode  # noqa: E402

MODES = ["bnn", "tnn", "tbn"]
SHAPES = [(5, 33, 7), (16, 95, 9), (37, 129, 24), (8, 256, 128)]


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _values(mode, m, k, n, seed):
    """{-1, 0, +1} (ternary side) or {-1, +1} (binary side) operands."""
    rng = np.random.default_rng(seed)
    tern = lambda shape: rng.integers(-1, 2, shape).astype(np.float32)  # noqa: E731
    bina = lambda shape: np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)  # noqa: E731
    a = bina((m, k)) if mode == "bnn" else tern((m, k))
    b = tern((k, n)) if mode == "tnn" else bina((k, n))
    return a, b


def _planes(mode, a, b):
    """Reference planes (uint32) of a (m, k) and b.T (n, k)."""
    ja, jb = jnp.asarray(a), jnp.asarray(b.T)
    if mode == "bnn":
        return (jenc.pack_binary(ja),), (jenc.pack_binary(jb),)
    if mode == "tnn":
        return jenc.pack_ternary(ja), jenc.pack_ternary(jb)
    return jenc.pack_ternary(ja), (jenc.pack_binary(jb),)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seg_bits", ixm.SEG_BITS_CHOICES)
@pytest.mark.parametrize("seg_chunk", [1, 3, 64])
def test_core_matches_reference_every_width_and_chunk(mode, seg_bits, seg_chunk):
    """Unfused and fused, with and without stored idx planes: equal to the
    reference's indexed cells and to the port's popcount path."""
    m, k, n = 6, 70, 11                     # kw = 3 words: 24/18/12 segments
    a, b = _values(mode, m, k, n, seed=seg_bits * 7 + seg_chunk)
    ja_pl, jb_pl = _planes(mode, a, b)
    ta_pl, tb_pl = tuple(_t(p) for p in ja_pl), tuple(_t(p) for p in jb_pl)
    jm, tm = JMode(mode), QuantMode(mode)
    keys = ixm.indexed_payload_keys(tm, seg_bits)
    jpay = {kk: jixm.segment_indices(p, seg_bits) for kk, p in zip(keys, jb_pl)}
    tpay = {kk: ixm.segment_indices(p, seg_bits) for kk, p in zip(keys, tb_pl)}
    for kk in keys:
        np.testing.assert_array_equal(tpay[kk].numpy(), np.asarray(jpay[kk]))
    want = np.asarray(jixm.indexed_matmul(jm, ja_pl, jb_pl, k, seg_bits=seg_bits,
                                          seg_chunk=seg_chunk))
    a_keys = ("bits",) if mode == "bnn" else ("plus", "minus")
    b_keys = ("plus", "minus") if mode == "tnn" else ("bits",)
    pop = ops.packed_matmul(dict(zip(a_keys, ta_pl)),
                            QTensor(payload=dict(zip(b_keys, tb_pl)), scale=None, mode=tm,
                                    shape=(k, n)), backend="torch")
    np.testing.assert_array_equal(want, (a @ b).astype(np.int32))
    rng = np.random.default_rng(5)
    row = (rng.random((m, 1)) + 0.5).astype(np.float32)
    col = (rng.random((1, n)) + 0.5).astype(np.float32)
    bias = rng.standard_normal((1, n)).astype(np.float32)
    jfused = np.asarray(jixm.indexed_matmul_fused(
        jm, ja_pl, jb_pl, k, jnp.asarray(row), jnp.asarray(col), jnp.asarray(bias),
        seg_bits=seg_bits, seg_chunk=seg_chunk))
    for payload in (None, tpay):
        got = ixm.indexed_matmul(tm, ta_pl, tb_pl, k, seg_bits=seg_bits,
                                 seg_chunk=seg_chunk, payload=payload)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), pop.numpy())
        fused = ixm.indexed_matmul_fused(tm, ta_pl, tb_pl, k, torch.from_numpy(row),
                                         torch.from_numpy(col), torch.from_numpy(bias),
                                         seg_bits=seg_bits, seg_chunk=seg_chunk,
                                         payload=payload)
        np.testing.assert_array_equal(fused.numpy(), jfused)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_qmm_indexed_equals_reference_and_popcount(mode, shape):
    """``qmm(backend="indexed")`` on the reference's packed weights (with
    and without its stored idx8 planes) and its activation statistics:
    equal to the reference's indexed ``qmm`` and to the port's popcount
    ``qmm``; ``lowbit_matmul`` equal to the exact product."""
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jm = JMode(mode)
    xa = jops.quantize_activations(jnp.asarray(x), jm)
    stats = ({"scale": np.asarray(xa["scale"])} if mode == "bnn" else
             {"thr": np.float32(0.7) * np.mean(np.abs(x), dtype=np.float32),
              "scale": np.asarray(xa["scale"])})
    for bits in (None, 8):
        jq = jops.pack_weights(jnp.asarray(w), jm, indexed_bits=bits)
        tq = interop.qtensor_from_numpy(jax.tree.map(np.asarray, jq.payload),
                                        np.asarray(jq.scale), None, mode, (k, n),
                                        device="cpu")
        want = np.asarray(jops.qmm(jnp.asarray(x), jq, backend="indexed",
                                   act_stats={kk: jnp.asarray(v) for kk, v in stats.items()}))
        got = ops.qmm(torch.from_numpy(x), tq, backend="indexed", act_stats=stats)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, ops.qmm(torch.from_numpy(x), tq, backend="torch",
                                        act_stats=stats))
    a, b = _values(mode, m, k, n, seed=m + n)
    got = ops.lowbit_matmul(torch.from_numpy(a), torch.from_numpy(b), QuantMode(mode),
                            backend="indexed")
    np.testing.assert_array_equal(got.numpy(), (a @ b).astype(np.int32))


def test_segment_indices_shift_mask():
    """The index of segment s of word w is (word >> s*b) & (2^b - 1),
    equal to the reference's on the same words."""
    words_u = np.array([[0xDEADBEEF, 0x01234567]], np.uint32)
    words = torch.from_numpy(words_u.view(np.int32))
    idx8 = ixm.segment_indices(words, 8)
    assert idx8.dtype == torch.uint8
    assert idx8.tolist() == [[0xEF, 0xBE, 0xAD, 0xDE, 0x67, 0x45, 0x23, 0x01]]
    idx4 = ixm.segment_indices(words, 4)
    assert idx4.shape == (1, 16) and idx4[0, :8].tolist() == [0xF, 0xE, 0xE, 0xB, 0xD, 0xA,
                                                                0xE, 0xD]
    for b in ixm.SEG_BITS_CHOICES:
        np.testing.assert_array_equal(ixm.segment_indices(words, b).numpy(),
                                      np.asarray(jixm.segment_indices(jnp.asarray(words_u), b)))
    assert ixm.segment_indices(words, 2).shape == (1, 32)
    with pytest.raises(ValueError, match="seg_bits"):
        ixm.segment_indices(words, 16)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seg_bits", ixm.SEG_BITS_CHOICES)
def test_payload_roundtrip_and_pack_weights(mode, seg_bits):
    """``pack_weights(indexed_bits=)`` stores (n, S) uint8 idx planes equal
    to the reference's on the same planes; the legacy dict drops them and
    the round-tripped container (which derives them) gives the same
    output."""
    rng = np.random.default_rng(seg_bits)
    w = torch.from_numpy(rng.standard_normal((70, 9)).astype(np.float32))
    tm = QuantMode(mode)
    qt = ops.pack_weights(w, tm, indexed_bits=seg_bits)
    plain = ops.pack_weights(w, tm)
    keys = ixm.indexed_payload_keys(tm, seg_bits)
    for kk, plane in zip(keys, (plain.payload[p] for p in
                                (("plus", "minus") if mode == "tnn" else ("bits",)))):
        assert qt.payload[kk].shape == (9, 3 * (32 // seg_bits))
        assert qt.payload[kk].dtype == torch.uint8
        ref = jixm.segment_indices(jnp.asarray(plane.numpy().view(np.uint32)), seg_bits)
        np.testing.assert_array_equal(qt.payload[kk].numpy(), np.asarray(ref))
    legacy = qt.to_legacy_dict()
    assert not any(kk in legacy for kk in keys)
    back = QTensor.from_legacy_dict(legacy, tm, k_valid=70)
    x = torch.from_numpy(rng.standard_normal((5, 70)).astype(np.float32))
    assert torch.equal(ops.qmm(x, qt, backend="indexed"), ops.qmm(x, back, backend="indexed"))
    assert torch.equal(ops.qmm(x, qt, backend="indexed"), ops.qmm(x, plain, backend="torch"))


def test_payload_keys_reject_non_bitplane_modes():
    with pytest.raises(ValueError, match="bit-plane"):
        ixm.indexed_payload_keys(QuantMode.INT8, 8)
    with pytest.raises(ValueError, match="bit-plane"):
        ixm.add_indexed_payload(ops.pack_weights(torch.ones((16, 4)), QuantMode.INT8))


def test_seg_bits_for_and_space_mirror_reference():
    from repro.tune.space import INDEXED_SPACE as JSPACE

    assert ixm.SEG_BITS_CHOICES == jixm.SEG_BITS_CHOICES
    assert ixm.INDEXED_SPACE.seg_bits == JSPACE.block_kw
    assert ixm.INDEXED_SPACE.word_chunk == JSPACE.word_chunk
    assert ixm.seg_bits_for(None) == jixm.seg_bits_for(None) == 8
    assert ixm.seg_bits_for(TileConfig()) == 8
    assert ixm.seg_bits_for(TileConfig(seg_bits=4)) == 4
    assert ixm.seg_bits_for(TileConfig(seg_bits=3)) == 2
    assert ixm.seg_bits_for(TileConfig(seg_bits=1)) == 2


def test_indexed_cells_registered_like_the_reference():
    for mode in MODES:
        for fused in (False, True):
            spec = registry.lookup(QuantMode(mode), "indexed", fused=fused)
            jspec = jregistry.lookup(JMode(mode), "indexed", fused=fused)
            assert spec.payload_aware and jspec.payload_aware
            assert spec.tunable is ixm.INDEXED_SPACE
    assert not registry.lookup(QuantMode.TNN, "cuda", fused=True).payload_aware


@pytest.mark.parametrize("name", ["tnn_indexed", "bnn_indexed", "tnn_mixed"])
def test_indexed_policies_validate(name):
    p = POLICIES[name]
    assert p.validate() is p
    assert p.backend_for("ffn_proj") == "indexed"
    assert p.backend_for("attn_proj") == ("cuda" if name == "tnn_mixed" else "indexed")


def test_tiles_choose_segment_width_and_chunk():
    """A blocking's seg_bits / word_chunk reach the core: every choice
    gives the same integers as the default."""
    a, b = _values("tnn", 7, 100, 13, seed=3)
    ja, jb = _planes("tnn", a, b)
    ta, tb = tuple(_t(p) for p in ja), tuple(_t(p) for p in jb)
    spec = registry.lookup(QuantMode.TNN, "indexed", fused=False)
    want = spec.fn(ta, tb, 100)
    for sb in (2, 4, 8):
        for wc in (1, 16):
            got = spec.fn(ta, tb, 100, tiles=TileConfig(word_chunk=wc, seg_bits=sb))
            assert torch.equal(got, want)
    np.testing.assert_array_equal(want.numpy(), (a @ b).astype(np.int32))
    assert encoding.packed_width(100) == ta[0].shape[1]
