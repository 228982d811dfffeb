"""The port's Hopper kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device (marker ``gpu``) and skips
without one; the file imports neither JAX nor the JAX package, so the
machine with the card runs it alone:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels_gpu.py

All comparisons are ``torch.equal``: the kernels count the same integers
and are built with ``--fmad=false``, so the eq. (2) epilogue rounds as
the plain version does.
"""

import pytest
import torch

from repro_torch.core import encoding
from repro_torch.core.conv import pack_conv_filters
from repro_torch.kernels import _build, ops
from repro_torch.kernels import bnn_matmul, tbn_matmul, tnn_matmul
from repro_torch.kernels.modes import QuantMode

pytestmark = pytest.mark.gpu

MODES = ["tnn", "tbn", "bnn"]
KERNELS = {"tnn": tnn_matmul, "tbn": tbn_matmul, "bnn": bnn_matmul}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _planes(vals: torch.Tensor, ternary: bool):
    return list(encoding.pack_ternary(vals)) if ternary else [encoding.pack_binary(vals)]


# (m, n, k) of the GeMM cases: on a 132-SM card the popcount tile plan
# picks 16 for the GEMM_GRID corners and the ragged cases, 32 for
# (1000, 130), 64 for the CNN's first im2col GeMM at batch 2 and the
# 9000-row case (the dense plan: 64 for the 9000-row case, else 32); the
# last two are deep enough that A streams through the ring instead of
# staying resident (kw = 129 in 64-row tiles, 500 in 16- or 32-row tiles);
# k = 130 and 33 give kw % 4 != 0 (4-byte weight copies in the dense
# kernel).
GEMM_CASES = [(72, 24, 128), (360, 96, 512), (37, 21, 130), (5, 3, 33),
              (1000, 130, 1152), (2048, 64, 288), (9000, 64, 4128),
              (40, 20, 16000)]


def _gemm_operands(device, mode, m, n, k, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randint(-1, 2, (m, k), generator=g, device=device).float()
    b = torch.randint(-1, 2, (n, k), generator=g, device=device).float()
    row = torch.rand((m, 1), generator=g, device=device) + 0.5
    col = torch.rand((1, n), generator=g, device=device) + 0.5
    bias = torch.randn((1, n), generator=g, device=device)
    return _planes(a, mode != "bnn"), _planes(b, mode == "tnn"), row, col, bias


def _row_scales(row):
    """The per-row scale as (m, 1) values (row stride 1), one per-tensor
    value (1, 1), and that value expanded to (m, 1) (row stride 0)."""
    one = row[:1]
    return [row, one, one.expand(row.shape[0], 1)]


def test_gemm_cases_cover_every_tile(cuda_device):
    from repro_torch.kernels._matmul_common import (DENSE_TILES, GEMM_TILES, gemm_tile,
                                                    sm_count)

    sms = sm_count(cuda_device.index or 0)
    assert {gemm_tile(m, n, sms) for m, n, _ in GEMM_CASES} == set(GEMM_TILES)
    assert {gemm_tile(m, n, sms, DENSE_TILES) for m, n, _ in GEMM_CASES} == set(DENSE_TILES)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", GEMM_CASES)
def test_gemm_kernel_matches_plain(cuda_device, mode, shape):
    m, n, k = shape
    a_pl, b_pl, row, col, bias = _gemm_operands(cuda_device, mode, m, n, k, m + k)
    ops_ = a_pl + b_pl
    mod = KERNELS[mode]
    k_int = getattr(mod, f"{mode}_matmul_cuda")
    k_fused = getattr(mod, f"{mode}_matmul_fused_cuda")
    p_int = getattr(mod, f"{mode}_matmul_torch")
    p_fused = getattr(mod, f"{mode}_matmul_fused_torch")
    _build.reset_launches()
    assert torch.equal(k_int(*ops_, k), p_int(*ops_, k))
    for r in _row_scales(row):
        for bb in (None, bias):
            assert torch.equal(k_fused(*ops_, k, r, col, bb), p_fused(*ops_, k, r, col, bb))
    assert _build.launches() == {f"lowbit_gemm_{mode}_i32": 1,
                                 f"lowbit_gemm_{mode}_fused": 6}


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a contiguous view that starts 4 bytes past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("mode", MODES)
def test_gemm_kernels_take_misaligned_planes(cuda_device, mode):
    """Planes that are views at a 4-byte, not 16-byte, aligned offset:
    kw % 4 == 0, so only the alignment keeps the dense kernel off its
    16-byte weight copies."""
    from repro_torch.kernels import dense_fused

    m, n, k = 100, 70, 512
    a_pl, b_pl, row, col, bias = _gemm_operands(cuda_device, mode, m, n, k, 5)
    a_mis, b_mis = [_misaligned(p) for p in a_pl], [_misaligned(p) for p in b_pl]
    qm = QuantMode(mode)
    fused = getattr(KERNELS[mode], f"{mode}_matmul_fused_cuda")
    plain = getattr(KERNELS[mode], f"{mode}_matmul_fused_torch")
    want = plain(*a_pl, *b_pl, k, row, col, bias)
    assert torch.equal(fused(*a_mis, *b_mis, k, row, col, bias), want)
    assert torch.equal(dense_fused.dense_matmul_fused_cuda(qm, a_mis, b_mis, k, row, col,
                                                           bias), want)
    assert torch.equal(dense_fused.dense_matmul_fused_cuda(qm, a_pl, b_mis, k, row, col,
                                                           bias), want)


def test_launch_on_another_device(cuda_device):
    """The runtime launches on its current device: operands on the second
    card must be computed there, and the current device left as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    other = torch.device("cuda", 1)
    a_pl, b_pl, row, col, bias = _gemm_operands(other, "tnn", 64, 48, 256, 3)
    current = torch.cuda.current_device()
    got = tnn_matmul.tnn_matmul_fused_cuda(*a_pl, *b_pl, 256, row, col, bias)
    assert torch.cuda.current_device() == current and got.device == other
    assert torch.equal(got, tnn_matmul.tnn_matmul_fused_torch(*a_pl, *b_pl, 256, row, col,
                                                              bias))


CONV_CASES = [((2, 8, 8, 32), (3, 3, 32, 16), 1, "SAME"),
              ((2, 7, 6, 8), (3, 3, 8, 70), 1, "SAME"),
              ((3, 9, 11, 40), (3, 3, 40, 7), 2, "VALID"),
              ((2, 10, 10, 64), (5, 5, 64, 33), 2, "SAME"),
              # several column blocks reuse one staged A tile
              ((2, 8, 8, 64), (3, 3, 64, 256), 1, "SAME"),
              # batch 1, odd H x W: tiles cross image rows; ragged last block
              ((1, 7, 9, 32), (3, 3, 32, 70), 1, "SAME"),
              ((1, 11, 13, 16), (5, 5, 16, 40), 2, "SAME"),
              # deep enough that A streams through the ring (ternary: 135
              # words; BNN: 288 words)
              ((1, 6, 6, 480), (3, 3, 480, 20), 1, "SAME"),
              ((1, 4, 5, 1000), (3, 3, 1000, 9), 1, "SAME")]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_conv_kernel_matches_plain(cuda_device, mode, case):
    xs, fs, stride, padding = CONV_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(case)
    x = torch.randn(xs, generator=g, device=cuda_device)
    f = torch.randn(fs, generator=g, device=cuda_device)
    for bias in (None, torch.linspace(-1, 1, fs[-1], device=cuda_device)):
        qt = pack_conv_filters(f, QuantMode(mode), bias=bias)
        _build.reset_launches()
        got = ops.qconv(x, qt, stride=stride, padding=padding, backend="cuda")
        assert _build.launches() == {f"conv_pack_{mode}": 1, f"lowbit_conv_{mode}": 1}
        plain = ops.qconv(x, qt, stride=stride, padding=padding, backend="torch")
        assert torch.equal(got, plain)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_conv_pack_kernel_matches_plain(cuda_device, mode, case):
    from repro_torch.kernels import conv_fused

    xs, fs, stride, padding = CONV_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(case + 20)
    x = torch.randn(xs, generator=g, device=cuda_device)
    kh, kw = fs[:2]
    stats = conv_fused.conv_act_stats(x, QuantMode(mode), kh, kw, stride, padding)
    _build.reset_launches()
    got = conv_fused.conv_pack_cuda(QuantMode(mode), x, kh, kw, stride, padding, stats)
    assert _build.launches() == {f"conv_pack_{mode}": 1}
    want = conv_fused.conv_pack_torch(QuantMode(mode), x, kh, kw, stride, padding, stats)
    assert len(got) == len(want) == (1 if mode == "bnn" else 2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_cuda_operands_never_run_plain(cuda_device):
    """A CUDA launch that the kernel refuses raises; nothing falls back."""
    a = torch.zeros((4, 2), dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        bnn_matmul.bnn_matmul_cuda(a, a, 64)
    p = torch.zeros((4, 2), dtype=torch.int32, device=cuda_device)
    row = torch.ones((4, 2), device=cuda_device)[:, :1]       # row stride 2
    col = torch.ones((1, 4), device=cuda_device)
    with pytest.raises(ValueError, match="row_scale"):
        bnn_matmul.bnn_matmul_fused_cuda(p, p, 64, row, col)
    with pytest.raises(ValueError, match="contiguous"):
        bnn_matmul.bnn_matmul_fused_cuda(p, p, 64, row[:1], torch.ones((4, 2),
                                         device=cuda_device)[:, 0])


@pytest.mark.parametrize("mode", MODES)
def test_entry_points_on_card_match_plain(cuda_device, mode):
    """qmm / packed_matmul / PaperCNN through the registry: per-tensor
    scales arrive as expanded views and must reach the kernel intact."""
    from repro_torch.cnn import PaperCNN
    from repro_torch.configs.paper_cnn import PAPER_CNN_SMOKE

    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn((50, 300), generator=g, device=cuda_device)
    qt = ops.pack_weights(torch.randn((300, 40), generator=g, device=cuda_device),
                          QuantMode(mode))
    _build.reset_launches()
    assert torch.equal(ops.qmm(x, qt), ops.qmm(x, qt, backend="torch"))
    xa = ops.quantize_activations(x, QuantMode(mode))
    assert torch.equal(ops.packed_matmul(xa, qt), ops.packed_matmul(xa, qt, backend="torch"))
    assert _build.launches() == {f"lowbit_gemm_{mode}_fused": 1, f"lowbit_gemm_{mode}_i32": 1}
    model = PaperCNN(PAPER_CNN_SMOKE, seed=1)
    plain = PaperCNN(PAPER_CNN_SMOKE, seed=1, backend="torch")
    imgs = torch.randn((3, 8, 8, 3), generator=g, device=cuda_device)
    assert torch.equal(model(imgs), plain(imgs))


# ---------------------------------------------------------------------------
# Dense backend (csrc/dense_tc.cu) and the u8/u4 baselines (csrc/affine_gemm.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", GEMM_CASES)
def test_dense_gemm_kernel_matches_plain(cuda_device, mode, shape):
    from repro_torch.kernels import dense_fused

    m, n, k = shape
    a_pl, b_pl, row, col, bias = _gemm_operands(cuda_device, mode, m, n, k, m + 1)
    qm = QuantMode(mode)
    popcount = getattr(KERNELS[mode], f"{mode}_matmul_fused_cuda")
    _build.reset_launches()
    for r in _row_scales(row)[:2]:
        for bb in (None, bias):
            got = dense_fused.dense_matmul_fused_cuda(qm, a_pl, b_pl, k, r, col, bb)
            assert torch.equal(got, dense_fused.dense_matmul_fused_torch(
                qm, a_pl, b_pl, k, r, col, bb))
            assert torch.equal(got, popcount(*a_pl, *b_pl, k, r, col, bb))
    assert _build.launches() == {f"dense_gemm_{mode}": 4, f"lowbit_gemm_{mode}_fused": 4}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_dense_conv_kernel_matches_plain(cuda_device, mode, case):
    from repro_torch.kernels import conv_fused, dense_fused

    xs, fs, stride, padding = CONV_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(case + 10)
    x = torch.randn(xs, generator=g, device=cuda_device)
    f = torch.randn(fs, generator=g, device=cuda_device)
    for bias in (None, torch.linspace(-1, 1, fs[-1], device=cuda_device)):
        qt = pack_conv_filters(f, QuantMode(mode), bias=bias)
        kh, kw, _, cout = qt.geometry
        stats = conv_fused.conv_act_stats(x, qt.mode, kh, kw, stride, padding)
        args = (qt.mode, x, conv_fused.conv_weight_planes(qt), qt.geometry, stride,
                padding, stats, qt.scale.reshape(1, cout),
                None if bias is None else bias.reshape(1, cout))
        _build.reset_launches()
        got = dense_fused.dense_conv_fused_cuda(*args)
        assert _build.launches() == {f"conv_pack_{mode}": 1, f"dense_conv_{mode}": 1}
        assert torch.equal(got, dense_fused.dense_conv_fused_torch(*args))
        assert torch.equal(got, ops.qconv(x, qt, stride=stride, padding=padding,
                                          backend="cuda"))


# (m, n, k) of the u8/u4 cases: the GEMM_GRID corners; k % 16 != 0 (A runs
# that cross the depth's end); n % 4 != 0 (B and the output byte by byte at
# the column edge) with n % 16 != 0; m below a tile; odd logical u4 depths
# (131, 77: a zero nibble pads both sides); the CNN's first im2col GeMM at
# batch 8; on a 132-SM card, tile 64 for the last three and tile 32 for
# every other case; more row blocks than the card holds CTAs, so a CTA
# walks several (60000 x 32), and a depth past the B chunk a CTA holds
# (1200 > 1152: B staged chunk by chunk for each row block).
AFFINE_CASES = [(72, 24, 128), (360, 96, 512), (37, 21, 131), (300, 200, 1000),
                (100, 64, 200), (90, 30, 256), (5, 70, 64), (33, 40, 77),
                (8192, 64, 288), (2100, 300, 96), (60000, 32, 288), (20000, 64, 1200)]


def _affine_operands(device, m, n, k, seed):
    from repro_torch.kernels import int4_matmul

    g = torch.Generator(device=device).manual_seed(seed)
    a8 = torch.randint(0, 256, (m, k), generator=g, device=device, dtype=torch.uint8)
    b8 = torch.randint(0, 256, (k, n), generator=g, device=device, dtype=torch.uint8)
    return a8, b8, int4_matmul.pack_nibbles_rows(a8 >> 4), int4_matmul.pack_nibbles_cols(b8 & 0xF)


def test_affine_cases_cover_every_tile(cuda_device):
    from repro_torch.kernels._matmul_common import AFFINE_TILES, gemm_tile, sm_count

    sms = sm_count(cuda_device.index or 0)
    assert {gemm_tile(m, n, sms, AFFINE_TILES) for m, n, _ in AFFINE_CASES} == \
        set(AFFINE_TILES)


@pytest.mark.parametrize("shape", AFFINE_CASES)
def test_affine_kernels_match_plain(cuda_device, shape):
    from repro_torch.kernels import int4_matmul, int8_matmul

    m, n, k = shape
    a8, b8, pa, pb = _affine_operands(cuda_device, m, n, k, k)
    _build.reset_launches()
    assert torch.equal(int8_matmul.int8_matmul_cuda(a8, b8),
                       int8_matmul.int8_matmul_torch(a8, b8))
    assert torch.equal(int4_matmul.int4_matmul_cuda(pa, pb),
                       int4_matmul.int4_matmul_torch(pa, pb))
    assert _build.launches() == {"affine_gemm_u8": 1, "affine_gemm_u4": 1}
    with pytest.raises(TypeError, match="uint8"):
        int8_matmul.int8_matmul_cuda(a8.to(torch.int32), b8)


def test_affine_kernels_in_any_depth_order(cuda_device):
    """The kernel's shared memory grows with the depth of B it holds (up to
    1152): a shallower launch between two deep ones leaves the deep one
    launchable (tile 64 for 3000 x 300 on a 132-SM card: ~104 KB, then
    ~72 KB, then ~104 KB again)."""
    from repro_torch.kernels import int4_matmul, int8_matmul

    for k in (1152, 640, 1152, 256, 1200):
        a8, b8, pa, pb = _affine_operands(cuda_device, 3000, 300, k, k + 1)
        assert torch.equal(int8_matmul.int8_matmul_cuda(a8, b8),
                           int8_matmul.int8_matmul_torch(a8, b8))
        assert torch.equal(int4_matmul.int4_matmul_cuda(pa, pb),
                           int4_matmul.int4_matmul_torch(pa, pb))


def _offset(t, nbytes):
    """``t`` (uint8) copied into a contiguous view ``nbytes`` past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = buf[nbytes:nbytes + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("nbytes", [1, 4, 8])
def test_affine_kernels_take_misaligned_operands(cuda_device, nbytes):
    """Operands 1, 4 or 8 bytes past a 16-byte boundary (row strides of 16
    bytes and more): the launcher takes the 1-, 4- or 8-byte copy of A (and
    byte loads of B where a 4-byte word does not fit), and the result is
    still the plain version's."""
    from repro_torch.kernels import int4_matmul, int8_matmul

    a8, b8, pa, pb = _affine_operands(cuda_device, 130, 72, 256, nbytes)
    want8 = int8_matmul.int8_matmul_torch(a8, b8)
    want4 = int4_matmul.int4_matmul_torch(pa, pb)
    a8, b8, pa, pb = (_offset(t, nbytes) for t in (a8, b8, pa, pb))
    assert a8.data_ptr() % 16 == nbytes
    _build.reset_launches()
    assert torch.equal(int8_matmul.int8_matmul_cuda(a8, b8), want8)
    assert torch.equal(int4_matmul.int4_matmul_cuda(pa, pb), want4)
    assert _build.launches() == {"affine_gemm_u8": 1, "affine_gemm_u4": 1}


@pytest.mark.parametrize("mode", ["int8", "int4", "f32", "bf16"])
def test_affine_and_float_qmm_on_card(cuda_device, mode):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((50, 300), generator=g, device=cuda_device)
    qt = ops.pack_weights(torch.randn((300, 40), generator=g, device=cuda_device),
                          QuantMode(mode))
    _build.reset_launches()
    got = ops.qmm(x, qt)
    if mode in ("int8", "int4"):
        assert _build.launches() == {f"affine_gemm_u{mode[-1]}": 1}
        assert torch.equal(got, ops.qmm(x, qt, backend="torch"))
        assert torch.equal(got, ops.qmm(x, qt, backend="dense"))    # -> "cuda"
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    cpu = ops.qmm(x.cpu(), qt.to("cpu"))
    assert torch.allclose(got.cpu(), cpu, rtol=1e-5, atol=1e-4)


def test_dense_cnn_on_card_matches_popcount(cuda_device):
    from repro_torch.cnn import PaperCNN
    from repro_torch.configs.paper_cnn import PAPER_CNN_SMOKE

    g = torch.Generator(device=cuda_device).manual_seed(9)
    imgs = torch.randn((3, 8, 8, 3), generator=g, device=cuda_device)
    dense = PaperCNN(PAPER_CNN_SMOKE, seed=2, backend="dense")
    popcount = PaperCNN(PAPER_CNN_SMOKE, seed=2)
    assert torch.equal(dense.features(imgs), popcount.features(imgs))
    assert torch.equal(dense(imgs), popcount(imgs))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-27b"])
def test_smoke_lm_on_card_matches_plain(cuda_device, arch):
    """A smoke LM packed under tnn on the card: prefill and two decode
    steps on the cuda backend == the plain versions, seven fused TNN
    GeMMs per layer per forward, the prefill's argmax == the full
    forward's."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import ShardLayout, model
    from repro_torch.models.kvcache import init_caches
    from repro_torch.models.packing import pack_lm_params

    cfg = get_smoke(arch).with_(dtype=torch.float32, quant_policy="tnn")
    plain = cfg.with_(quant_backend="torch")
    lay = ShardLayout()
    g = torch.Generator(device=cuda_device).manual_seed(4)
    params = pack_lm_params(model.init_lm(g, cfg, lay, device=cuda_device), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=g, device=cuda_device)
    caches = {c: init_caches(c, lay, 2, 16, dtype=torch.float32, device=cuda_device)
              for c in (cfg, plain)}
    _build.reset_launches()
    got, _ = model.prefill(params, {"tokens": toks[:, :8]}, caches[cfg], cfg, lay)
    assert _build.launches() == {"lowbit_gemm_tnn_fused": 7 * cfg.num_layers}
    want, _ = model.prefill(params, {"tokens": toks[:, :8]}, caches[plain], plain, lay)
    assert torch.equal(got, want)
    full, _ = model.forward(params, {"tokens": toks[:, :8]}, cfg, lay)
    assert torch.equal(got[:, -1].argmax(-1), full[:, -1].argmax(-1))
    for t in (8, 9):
        tok = toks[:, 8:9] if t == 8 else got.argmax(-1)
        got, _ = model.decode_step(params, {"tokens": tok}, caches[cfg], t, cfg, lay)
        want, _ = model.decode_step(params, {"tokens": tok}, caches[plain], t, plain, lay)
        assert torch.equal(got, want)
        assert torch.isfinite(got).all()


def _tnn_gemms_per_forward(cfg):
    """Fused TNN GeMM launches of one forward of a model packed under tnn:
    4 per attention mixer, 2 per SSM mixer, 3 per dense FFN, 3 per expert
    (every expert runs on its capacity rows) plus 3 for a shared expert."""
    per = {"A": 4, "AL": 4, "M": 2, "D": 3, "-": 0,
           "E": 3 * cfg.num_experts + (3 if cfg.shared_expert_d_ff else 0)}
    return cfg.num_periods * sum(per[m] + per[f] for m, f in cfg.layer_pattern)


@pytest.mark.parametrize("arch,kv", [("qwen2-moe-a2.7b", "bf16"), ("mixtral-8x22b", "bf16"),
                                     ("mamba2-1.3b", "bf16"),
                                     ("jamba-1.5-large-398b", "bf16"),
                                     ("tinyllama-1.1b", "tnn2"),
                                     ("gemma2-27b", "tnn2-oracle")])
def test_smoke_moe_ssm_paged_on_card_matches_plain(cuda_device, arch, kv):
    """MoE, SSM, hybrid and paged-cache smoke models packed under tnn on
    the card: prefill (chunks of 4 through pagers on a paged cache) and
    two greedy decode steps on the cuda backend == the plain versions,
    the fused TNN GeMM launched exactly as often as the projections ask,
    and nothing else."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import ShardLayout, model
    from repro_torch.models import paged_kvcache as paged
    from repro_torch.models.kvcache import init_caches
    from repro_torch.models.packing import pack_lm_params

    cfg = get_smoke(arch).with_(dtype=torch.float32, quant_policy="tnn", kv_cache_dtype=kv)
    lay = ShardLayout()
    g = torch.Generator(device=cuda_device).manual_seed(6)
    params = pack_lm_params(model.init_lm(g, cfg, lay, device=cuda_device), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=g, device=cuda_device)

    def run(c):
        caches = init_caches(c, lay, 2, 16, page_size=4, prefill_chunk=4,
                             device=cuda_device)
        outs = []
        if kv == "bf16":
            lg, caches = model.prefill(params, {"tokens": toks}, caches, c, lay)
        else:
            pagers = paged.make_pagers(caches, 2)
            for start in (0, 4):
                for slot in range(2):
                    for pg in pagers:
                        pg.ensure(slot, start + 4)
                caches = paged.sync_page_tables(caches, pagers)
                st = torch.tensor([[start, 4]] * 2, dtype=torch.int32, device=cuda_device)
                lg, caches = model.decode_step(params, {"tokens": toks[:, start:start + 4]},
                                               caches, st, c, lay)
            for slot in range(2):
                for pg in pagers:
                    pg.ensure(slot, 10)
            caches = paged.sync_page_tables(caches, pagers)
        outs.append(lg)
        for t in (8, 9):
            lg, caches = model.decode_step(params, {"tokens": lg[:, -1:].argmax(-1)}, caches,
                                           t, c, lay)
            outs.append(lg)
        return outs

    _build.reset_launches()
    got = run(cfg)
    forwards = 3 if kv == "bf16" else 4
    assert _build.launches() == {"lowbit_gemm_tnn_fused": forwards * _tnn_gemms_per_forward(cfg)}
    want = run(cfg.with_(quant_backend="torch"))
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,mode", [("tnn_indexed", "tnn"), ("bnn_indexed", "bnn"),
                                       ("tnn_mixed", "tnn")])
def test_indexed_policies_on_card_equal_popcount(cuda_device, name, mode):
    """The indexed backend (plain PyTorch on the card) gives the popcount
    kernel's logits bit for bit on a packed smoke LM."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import ShardLayout, model
    from repro_torch.models.packing import pack_lm_params

    cfg = get_smoke("tinyllama-1.1b").with_(dtype=torch.float32, quant_policy=name)
    lay = ShardLayout()
    g = torch.Generator(device=cuda_device).manual_seed(7)
    params = pack_lm_params(model.init_lm(g, cfg, lay, device=cuda_device), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=g, device=cuda_device)
    got, _ = model.forward(params, {"tokens": toks}, cfg, lay)
    want, _ = model.forward(params, {"tokens": toks}, cfg.with_(quant_policy=mode), lay)
    assert torch.equal(got, want)


def test_quantlinear_backward_on_card(cuda_device):
    from repro_torch.core import QuantLinear

    layer = QuantLinear(256, 96, mode=QuantMode.TNN)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    params = layer.init(g, device=cuda_device)
    x = (torch.randn((40, 256), generator=g, device=cuda_device) * 1.2).requires_grad_(True)
    w = params["w"].requires_grad_(True)
    y = layer.apply({"w": w}, x)
    assert torch.equal(y, layer.apply_packed(layer.pack(params), x))
    c = torch.randn(y.shape, generator=g, device=cuda_device)
    (y * c).sum().backward()
    torch.backends.cuda.matmul.allow_tf32 = False
    xd, wd, cd = x.detach().double(), w.detach().double(), c.double()
    gx = (cd @ wd.t()) * (xd.abs() <= 1)
    assert torch.allclose(x.grad.double(), gx, rtol=1e-5, atol=1e-5)
    assert torch.allclose(w.grad.double(), xd.t() @ cd, rtol=1e-5, atol=1e-5)
