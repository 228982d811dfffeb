"""The frozen work arithmetic (``gpubench/work``) equal to the port's
``repro_torch.roofline.analysis`` at every cell's shapes."""

from __future__ import annotations

import pytest

import smoke  # noqa: F401  (puts src/ and the repository on sys.path)
from gpubench import harness, lm
from gpubench.work import roofline as frozen
from repro_torch.roofline import analysis as program


def _same(a, b):
    assert a.ops.keys() == b.ops.keys() or {k for k, v in a.ops.items() if v} == \
        {k for k, v in b.ops.items() if v}
    for k in set(a.ops) | set(b.ops):
        assert a.ops.get(k, 0.0) == pytest.approx(b.ops.get(k, 0.0), rel=1e-12)
    assert a.bytes == pytest.approx(b.bytes, rel=1e-12)


def test_peaks():
    hw, ref = frozen.HW(), program.HW()
    for cls in ("f32", "bf16", "int8", "popc"):
        assert hw.peak(cls) == ref.peak(cls)
    assert hw.hbm_bw == ref.hbm_bw


def test_cnn_kernels():
    cell = harness.find_cell("vgg_small.b1024")
    batch = cell.traffic["batch"]
    want = []
    for mode, b, h, w, cin, k, s, oh, ow, hp, wp, cout in frozen.cnn_layers(cell.config, batch):
        if mode in ("f32", "bf16"):
            continue
        want.append(program.conv_pack_work(mode, b, h, w, cin, hp, wp))
        want.append(program.conv_work(mode, b, hp, wp, cin, k, k, s, oh, ow, cout,
                                      k * k * -(-cin // 32)))
    got = frozen.cnn_kernel_work(cell.config, batch)
    assert len(got) == len(want) == 2 * sum(c["mode"] in ("tnn", "tbn", "bnn")
                                            for c in cell.config["convs"])
    for a, b in zip(got, want):
        _same(a, b)


def test_cnn_layer_shapes():
    from repro_torch.kernels import ops  # noqa: F401  (imports conv_fused in order)
    from repro_torch.kernels.conv_fused import conv_out_hw

    cell = harness.find_cell("vgg_small.b1024")
    for _, _, h, w, _, k, s, oh, ow, hp, wp, _ in frozen.cnn_layers(cell.config, 4):
        poh, pow_, ph, pw = conv_out_hw(h, w, k, k, s, "SAME")
        assert (oh, ow, hp, wp) == (poh, pow_, h + ph, w + pw)


@pytest.mark.parametrize("name", ["mamba2.prefill_8x1024", "mamba2.qat_8x512"])
def test_lm_projections(name):
    cell = harness.find_cell(name)
    tr = cell.traffic
    batch, seq = tr["batch"], tr.get("prompt_len", tr.get("seq"))
    mcfg = lm.model_config(cell.config)
    assert frozen.proj_shapes(cell.config, batch * seq) == program.proj_shapes(
        mcfg, batch * seq, 0)
    got = frozen.prefill_kernel_work(cell.config, batch, seq)
    assert len(got) == 96
    for (m, n, k), a in zip(program.proj_shapes(mcfg, batch * seq, 0), got):
        _same(a, program.gemm_work("tnn", m, n, -(-k // 32), k, True))
    _, prefill_ms = program.lm_bounds(mcfg, batch, seq, 0, 0)
    popc = frozen.Work({"popc": frozen.prefill_step_work(cell.config, batch, seq).ops["popc"]})
    assert popc.bound()[0] == pytest.approx(prefill_ms, rel=1e-12)


def test_train_float_products():
    """The QAT step's float products as ``train_step_flops`` counts them,
    less the remat recompute's (the least work runs each forward once)."""
    cell = harness.find_cell("mamba2.qat_8x512")
    tr = cell.traffic
    cfg = cell.config
    mcfg = lm.model_config(cfg, remat=False, remat_block=False)
    w = frozen.train_step_work(cfg, tr["batch"], tr["seq"], 1)
    ssd = frozen.ssd_forward_flops(cfg, tr["batch"], tr["seq"])
    want = program.train_step_flops(mcfg, tr["batch"], tr["seq"])
    # train_step_flops: the head at 6 m d V, the SSD's four passes of which
    # remat's recompute is one; frozen: the head in bf16, three passes
    head = 6.0 * tr["batch"] * tr["seq"] * cfg["d_model"] * mcfg.vocab_size
    assert w.ops["bf16"] == pytest.approx(head, rel=1e-12)
    assert w.ops["f32"] == pytest.approx(want - ssd - head, rel=1e-12)
