"""``gpubench/work/moe.py`` against counts made by hand at the smoke
shapes of ``qwen2moe.prefill_16x512``, and its per-GeMM bytes and
operations against the program's ``roofline.analysis.gemm_work``."""

from __future__ import annotations

import pytest

from smoke import smoke_cell
from gpubench.work import moe as work
from gpubench.work.roofline import HW, bound_ms
from repro_torch.roofline import analysis as program

CELL = "qwen2moe.prefill_16x512"


@pytest.fixture
def cut():
    cell = smoke_cell(CELL)
    return cell.config, cell.traffic["batch"], cell.traffic["prompt_len"]


def test_shapes_by_hand(cut):
    cfg, b, s = cut
    assert (cfg["d_model"], cfg["num_heads"], cfg["head_dim"], cfg["d_ff"],
            cfg["num_experts"], cfg["num_experts_per_tok"], cfg["shared_expert_d_ff"]) == \
        (64, 4, 16, 48, 8, 4, 96)
    m = b * s
    assert work.dense_shapes(cfg, m) == [(64, 64, 64, True), (64, 64, 64, True),
                                         (64, 64, 64, True), (64, 64, 64, False),
                                         (64, 96, 64, False), (64, 96, 64, False),
                                         (64, 64, 96, False)]
    routed = work.routed_shapes(cfg, m * cfg["num_experts_per_tok"])
    assert routed == [(256, 48, 64), (256, 48, 64), (256, 64, 48)]
    assert all(r == b * s * cfg["num_experts_per_tok"] for r, _, _ in routed)


def test_kernel_work_by_hand(cut):
    cfg, b, s = cut
    got = work.prefill_kernel_work(cfg, b, s)
    assert len(got) == 2 * (4 + 3 + 3)
    # a layer: q, k, v, o at 64 x 64 x 2 words; the shared expert 64 x 96 x 2
    # words twice and 64 x 64 x 3 words; the routed ones 256 rows, 8 experts
    popc = 2 * (4 * 64 * 64 * 2 * 2 + 2 * 64 * 96 * 2 * 2 + 64 * 64 * 3 * 2
                + 2 * 256 * 48 * 2 * 2 + 256 * 64 * 2 * 2)
    assert sum(w.ops["popc"] for w in got) == popc
    q = got[0]
    assert q.bytes == 4 * 2 * (64 * 2 + 64 * 2) + 4 * 64 * 64 + 4 * (64 + 64) + 4 * 64
    up = got[8]
    assert up.bytes == 4 * 2 * (256 * 2 + 8 * 48 * 2) + 4 * 256 * 48 + 4 * (256 + 8 * 48)


def test_dense_gemms_match_the_program(cut):
    cfg, b, s = cut
    m = b * s
    got = work.prefill_kernel_work(cfg, b, s)[:7]
    for (mm, n, k, biased), w in zip(work.dense_shapes(cfg, m), got):
        want = program.gemm_work("tnn", mm, n, -(-k // 32), k, True)
        assert w.ops["popc"] == want.ops["popc"]
        assert w.bytes == want.bytes + (4 * n if biased else 0)


def test_grouped_bound_under_the_experts_own(cut):
    """One GeMM per expert on its share of the rows never bounds below the
    grouped count, however the rows fall."""
    cfg, b, s = cut
    rows, e = b * s * cfg["num_experts_per_tok"], cfg["num_experts"]
    for share in ([rows // e] * e, [rows - 7 * 4] + [4] * 7):
        each = [program.gemm_work("tnn", r, 48, 2, 64, True) for r in share]
        grouped = bound_ms([work.grouped_gemm_work("tnn", rows, 48, 2, e)])
        assert bound_ms(each) >= grouped * (1 - 1e-12)


def test_step_work_by_hand(cut):
    cfg, b, s = cut
    m, v = b * s, cfg["vocab_size"]
    w = work.prefill_step_work(cfg, b, s)
    assert w.ops["popc"] == sum(x.ops["popc"] for x in work.prefill_kernel_work(cfg, b, s))
    # router 2 m d E, gate 2 m d, causal attention 2 B H dh S (S + 1), a layer
    assert w.ops["f32"] == 2 * (2 * m * 64 * 8 + 2 * m * 64 + 2 * b * 4 * 16 * s * (s + 1))
    assert w.ops["bf16"] == 2 * b * 64 * v
    dense = 3 * (2 * 4 * 64 * 2 + 4 * 64 + 4 * 64) + (2 * 4 * 64 * 2 + 4 * 64) \
        + 2 * (2 * 4 * 96 * 2 + 4 * 96) + (2 * 4 * 64 * 3 + 4 * 64)
    routed = 8 * (2 * (2 * 4 * 48 * 2 + 4 * 48) + (2 * 4 * 64 * 2 + 4 * 64))
    layer = dense + routed + 4 * 64 * 8 + 4 * 64 + 2 * 2 * m * 64
    assert w.bytes == 2 * layer + 2 * m * 64 + 2 * 64 * v + 4 * b * v + 8 * m
    assert w.bound(HW())[0] > 0
