"""On the card, at each cell's own size: the program passes its limits and
the control (the reference one precision down in the program's place:
bfloat16 for the CNN's and the prefill's float32 work, TF32 products for
the QAT step's) fails at least one, on three seeds."""

from __future__ import annotations

import pytest

from smoke import CELLS
from gpubench import calibrate, harness

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    harness.set_cache_dirs()
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_program_passes(card, name):
    import torch

    cell = harness.find_cell(name)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"needs {cell.chips} CUDA devices")
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    for seed in (3000000101, 3000000102, 3000000103):
        got = calibrate.readings(cell, seed, 3, card, control=True)
        assert all(v <= limits[k] for k, v in got["program"].items()), got
        assert any(v > limits[k] for k, v in got["control"].items()), got
