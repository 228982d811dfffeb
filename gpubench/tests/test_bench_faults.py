"""A run with the timed path broken underneath comes out not correct: for
each fault a cell can have, planted in the program at smoke size on the
CPU (``calibrate.plant``, on every rank), the rest of the run as the
benchmark drives it.  And the control (the reference one precision down in the program's
place) fails a limit that the program passes."""

from __future__ import annotations

import pytest
import torch

from smoke import smoke_cell
from gpubench import calibrate, run

CASES = [("vgg_small.b1024", "half"), ("vgg_small.b1024", "altered"),
         ("vgg_small.b1024", "image"), ("vgg_small.b1024", "channels"),
         ("vgg_small.b1024", "stale"), ("mamba2.prefill_8x1024", "stale"),
         ("mamba2.prefill_8x1024", "half"), ("mamba2.prefill_8x1024", "altered"),
         ("mamba2.qat_8x512", "half"), ("mamba2.qat_8x512", "altered"),
         ("mamba2.qat_8x512", "unchanged")]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault):
    cell = smoke_cell(name)
    sound = run.run_cell(cell, 41, 0.1, False, torch.device("cpu"))
    assert sound["correct"], sound["checks"]
    broken = run.run_cell(cell, 41, 0.1, False, torch.device("cpu"), fault=fault)
    assert not broken["correct"], broken["checks"]


@pytest.mark.parametrize("name", ["vgg_small.b1024", "mamba2.prefill_8x1024"])
def test_control_fails_a_limit(name):
    """At smoke size too the program passes every limit and the control
    (bfloat16 for the float32 work; the QAT cell's TF32 control has no
    effect on the CPU) fails one, reading over ten times the program."""
    cell = smoke_cell(name)
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    got = calibrate.readings(cell, 43, 1, torch.device("cpu"), control=True)
    assert all(v <= limits[k] for k, v in got["program"].items()), got
    assert any(c > max(limits[k], 10 * got["program"][k])
               for k, c in got["control"].items()), got
