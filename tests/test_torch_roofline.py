"""The port's roofline tooling (``repro_torch.roofline``) against the JAX
package and against PERF.md's kernel table, on the CPU.

* ``ModelConfig.param_counts`` equal to the reference's for all ten
  configs, full and smoke (exact integers);
* ``model_flops`` equal to the reference's (exact);
* the per-kernel work functions give PERF.md §6's "bound ms" column at
  its printed precision: the GeMM rows summed over the ``GEMM_GRID``
  diagonal, the conv rows over ``PAPER_CNN``'s layers at batch 256, at
  the 1,980 MHz maximum SM clock of the card those rows were measured on;
* ``kernel_work`` of every recorded key, ``train_step_flops`` of the
  TinyLlama-1.1B QAT step (exactly 18,996,640,350,208) and
  ``roofline_from_artifact``'s terms on a hand-made record (exact
  arithmetic on the stated rates).
"""

import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.roofline.analysis import model_flops as jmodel_flops
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.paper_cnn import GEMM_GRID, PAPER_CNN
from repro_torch.roofline import analysis as A

ARCH_NAMES = sorted(JARCHS)
HW_1980 = A.HW(sm_clock_hz=1980e6)
DIAG = list(zip(GEMM_GRID["height"], GEMM_GRID["width"], GEMM_GRID["depth"]))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_counts_match_reference(arch):
    assert get_config(arch).param_counts() == jget_config(arch).param_counts()
    assert get_smoke(arch).param_counts() == jget_smoke(arch).param_counts()


def test_model_flops_match_reference():
    for arch in ARCH_NAMES:
        pc = get_config(arch).param_counts()
        for tokens in (1, 4096 * 256, 32768 * 32):
            for kind in ("train", "prefill", "decode"):
                assert A.model_flops(pc["total"], pc["active"], tokens, kind) == \
                    jmodel_flops(pc["total"], pc["active"], tokens, kind)


def _sum_bound(works):
    ms = [w.bound(HW_1980)[0] for w in works]
    by = {w.bound(HW_1980)[1] for w in works}
    return sum(ms), "operations" if "operations" in by else "bytes"


def _cnn_layers(batch=256):
    """(mode, b, h, w, cin, cout, kh, hp, wp, oh, ow, words) of each
    low-bit PAPER_CNN layer (3x3 SAME, stride 1)."""
    out, hw, c_in = [], PAPER_CNN.img_size, PAPER_CNN.c_in
    for spec in PAPER_CNN.convs:
        k = spec.kernel
        if spec.mode != "bf16":
            out.append((spec.mode, batch, hw, hw, c_in, spec.c_out, k, hw + k - 1, hw + k - 1,
                        hw, hw, k * k * -(-c_in // 32)))
        hw = hw // 2 if spec.pool else hw
        c_in = spec.c_out
    return out


# PERF.md §6 "bound ms (by)", as printed there
GEMM_ROWS = {("tnn", True): (0.000389, "operations"), ("tbn", True): (0.000389, "operations"),
             ("bnn", True): (0.000195, "operations"), ("tnn", False): (0.000389, "operations"),
             ("tbn", False): (0.000389, "operations"), ("bnn", False): (0.000195, "operations")}
DENSE_ROWS = {"tnn": (0.000103, "bytes"), "tbn": (9.91e-05, "bytes"), "bnn": (8.73e-05, "bytes")}
CONV_ROWS = {"tnn": 0.14443, "tbn": 0.14443, "bnn": 0.03611}
PACK_ROWS = {"tnn": 0.01613, "tbn": 0.01081, "bnn": 0.00263}
DENSE_CONV_ROWS = {"tnn": 0.04508, "tbn": 0.02004, "bnn": 0.00752}


def _rounds_to(got: float, printed: float) -> bool:
    """``got`` rounded to the significant digits ``printed`` shows is
    ``printed`` (0.000389: 3 digits; 0.14443: 5; 9.91e-05: 3)."""
    mantissa = f"{printed:e}".split("e")[0].rstrip("0").replace(".", "")
    return float(f"{got:.{len(mantissa)}g}") == printed


@pytest.mark.parametrize("mode,fused", sorted(GEMM_ROWS))
def test_gemm_rows_match_perf_table(mode, fused):
    ms, by = _sum_bound([A.gemm_work(mode, m, n, -(-k // 32), k, fused) for m, n, k in DIAG])
    want, want_by = GEMM_ROWS[(mode, fused)]
    assert _rounds_to(ms, want), (ms, want)
    assert by == want_by


@pytest.mark.parametrize("mode", sorted(DENSE_ROWS))
def test_dense_gemm_rows_match_perf_table(mode):
    ms, by = _sum_bound([A.dense_gemm_work(mode, m, n, -(-k // 32), k) for m, n, k in DIAG])
    assert _rounds_to(ms, DENSE_ROWS[mode][0]), ms
    assert by == DENSE_ROWS[mode][1]


def test_affine_rows_match_perf_table():
    u8, by8 = _sum_bound([A.affine_gemm_work(m, n, k) for m, n, k in DIAG])
    u4, by4 = _sum_bound([A.affine_gemm_work(m, n, k, u4=True) for m, n, k in DIAG])
    assert _rounds_to(u8, 0.000193) and by8 == "bytes", u8
    assert _rounds_to(u4, 0.000132) and by4 == "bytes", u4


@pytest.mark.parametrize("mode", ["tnn", "tbn", "bnn"])
def test_conv_rows_match_perf_table(mode):
    layers = [lay for lay in _cnn_layers() if lay[0] == mode]
    pop = [A.conv_fused_work(mode, b, h, w, cin, kh, kh, oh, ow, cout, words)
           for _, b, h, w, cin, cout, kh, hp, wp, oh, ow, words in layers]
    dense = [A.conv_fused_work(mode, b, h, w, cin, kh, kh, oh, ow, cout, words, dense=True)
             for _, b, h, w, cin, cout, kh, hp, wp, oh, ow, words in layers]
    pack = [A.conv_pack_work(mode, b, h, w, cin, hp, wp)
            for _, b, h, w, cin, cout, kh, hp, wp, oh, ow, words in layers]
    ms, by = _sum_bound(pop)
    assert _rounds_to(ms, CONV_ROWS[mode]) and by == "operations", ms
    ms, by = _sum_bound(dense)
    assert _rounds_to(ms, DENSE_CONV_ROWS[mode]) and by == "bytes", ms
    ms, by = _sum_bound(pack)
    assert _rounds_to(ms, PACK_ROWS[mode]) and by == "bytes", ms


def test_kernel_work_dispatches_every_key():
    gemm = {"m": 8, "n": 16, "kw": 3, "k": 70}
    for mode in ("tnn", "tbn", "bnn"):
        assert A.kernel_work(f"lowbit_gemm_{mode}_fused", gemm).ops == \
            A.gemm_work(mode, 8, 16, 3, 70, True).ops
        assert A.kernel_work(f"lowbit_gemm_{mode}_i32", gemm).bytes == \
            A.gemm_work(mode, 8, 16, 3, 70, False).bytes
        assert A.kernel_work(f"dense_gemm_{mode}", gemm).ops == {"int8": 2.0 * 8 * 16 * 70}
        pack = {"b": 2, "h": 5, "w": 5, "c": 40, "hp": 7, "wp": 7}
        assert A.kernel_work(f"conv_pack_{mode}", pack).bytes == \
            2 * 5 * 5 * 40 * 4 + 4 * (1 if mode == "bnn" else 2) * 2 * 7 * 7 * 2
        conv = {"b": 2, "hp": 7, "wp": 7, "cin": 40, "kh": 3, "kw": 3, "stride": 1, "oh": 5,
                "ow": 5, "cout": 16, "words": 18}
        assert A.kernel_work(f"lowbit_conv_{mode}", conv).ops == \
            {"popc": float(50 * 16 * 18 * A.NPOPC[mode])}
        assert A.kernel_work(f"dense_conv_{mode}", conv).ops == {"int8": 2.0 * 50 * 16 * 9 * 40}
    for tag, u4 in (("u8", False), ("u4", True)):
        assert A.kernel_work(f"affine_gemm_{tag}", {"m": 4, "n": 6, "k": 9}).bytes == \
            A.affine_gemm_work(4, 6, 9, u4).bytes
    with pytest.raises(KeyError):
        A.kernel_work("no_such_kernel", {})


def test_train_step_flops_tinyllama():
    cfg = get_config("tinyllama-1.1b", quant_policy="tnn")
    assert A.train_step_flops(cfg, 8, 512) == 18_996_640_350_208


def test_roofline_terms_from_a_record():
    hw = A.HW()
    rec = {"num_devices": 256, "cost": {"flops": 1.0, "bytes accessed": 3.35e12},
           "collectives": {"total": 450e9 + 50e9},
           "static": {"ops_by_class": {"f32": 67e12, "bf16": 989e12 / 2,
                                       "popc": hw.popc_per_s},
                      "collective_bytes_by_axis": {"model": 450e9, "pod": 50e9}}}
    t = A.roofline_from_artifact(rec, hw)
    assert t.compute_s == 2.5 and t.memory_s == 1.0 and t.collective_s == 2.0
    assert t.dominant == "compute" and t.step_time_s == 2.5 and t.chips == 256
    assert t.compute_s_by_class == {"f32": 1.0, "bf16": 0.5, "popc": 1.0}
    w = A.Work({"int8": 1.979e15}, 6.7e12)
    assert w.bound(hw) == (2000.0, "bytes")
    assert (w + A.Work({"int8": 1.0}, 1.0)).ops == {"int8": 1.979e15 + 1.0}
