"""Each cell's reference against the port's plain path (``backend="torch"``)
at smoke size on the CPU: the whole run (set-up, window, check) passes
the cell's limits."""

from __future__ import annotations

import pytest
import torch

from smoke import CELLS, smoke_cell
from gpubench import run


def _plain(cell):
    if cell.traffic["driver"] == "image_batches":
        cell.traffic["backend"] = "torch"
    else:
        cell.config["quant_backend"] = "torch"
    return cell


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [7, 2**33 + 5])
def test_reference_agrees_with_plain_path(name, seed):
    cell = _plain(smoke_cell(name))
    result = run.run_cell(cell, seed, 0.2, False, torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_per_layer_metrics(name):
    """A ``--trace 1`` run's line: per-layer metrics (those a CPU run can
    read: none from the device), ``busy_s``, ``window_s`` and a breakdown."""
    cell = smoke_cell(name)
    result = run.run_cell(cell, 3, 0.2, True, torch.device("cpu"))
    assert result["correct"]
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "checks"


def test_same_seed_same_inputs():
    cell = smoke_cell("mamba2.prefill_8x1024")
    from gpubench import harness

    ref = harness.load_module("reference", cell.config["name"])
    a = ref.make_params(cell.config, 2**40 + 3, torch.device("cpu"), torch.bfloat16)
    b = ref.make_params(cell.config, 2**40 + 3, torch.device("cpu"), torch.bfloat16)
    assert torch.equal(a["blocks"][0]["mixer"]["in_proj"]["w"],
                       b["blocks"][0]["mixer"]["in_proj"]["w"])
    assert (ref.make_tokens(cell.config, 9, 2, 2, 8) == ref.make_tokens(cell.config, 9, 2, 2, 8)
            ).all()
