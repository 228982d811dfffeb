"""``qwen2moe.prefill_16x512``'s faults and control at smoke size on the
CPU: each part of the published block left out of the program
(``drivers/lm_prefill_moe.FAULTS``, planted through ``calibrate.plant``)
makes the run not correct, and the control (the reference in bfloat16
for its float32 work, in the program's place) fails a limit that the
program passes, reading over ten times the program."""

from __future__ import annotations

import pytest
import torch

from smoke import smoke_cell
from gpubench import calibrate, harness, run

CELL = "qwen2moe.prefill_16x512"
FAULTS = sorted(harness.load_module("drivers", "lm_prefill_moe").FAULTS)


def test_the_four_faults():
    assert FAULTS == ["capacity", "no_bias", "renormalised", "ungated"]


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(fault):
    cell = smoke_cell(CELL)
    sound = run.run_cell(cell, 41, 0.1, False, torch.device("cpu"))
    assert sound["correct"], sound["checks"]
    broken = run.run_cell(cell, 41, 0.1, False, torch.device("cpu"), fault=fault)
    assert not broken["correct"], broken["checks"]


def test_control_fails_a_limit():
    cell = smoke_cell(CELL)
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    got = calibrate.readings(cell, 43, 1, torch.device("cpu"), control=True)
    assert all(v <= limits[k] for k, v in got["program"].items()), got
    assert any(c > max(limits[k], 10 * got["program"][k])
               for k, c in got["control"].items()), got


def test_unknown_field_fails_before_set_up():
    """A configuration key the program's ModelConfig lacks (a parent
    without the published block's fields) stops the run at once."""
    cell = smoke_cell(CELL)
    cell.config["moe_dropless_v2"] = True
    drv = harness.load_module("drivers", "lm_prefill_moe")
    with pytest.raises(RuntimeError, match="moe_dropless_v2"):
        drv.Run(cell, 1, torch.device("cpu"))
