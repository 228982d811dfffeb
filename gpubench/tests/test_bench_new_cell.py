"""A cell is added to the benchmark as new files and new entries in
``BENCHMARK.json`` only: a copy of ``gpubench/`` with the toy cells of
``toycell.py`` added (a configuration, its reference, two traffic mixes,
limits, smoke files, a driver with its own fault and a metric reader)
passes its own ``test_bench_cells.py``, and both toy cells, one on one
chip and one on two gloo ranks, run through ``run_cell`` on the CPU."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import toycell
from smoke import ROOT

SRC = str(ROOT / "src")


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return toycell.make_copy(tmp_path_factory.mktemp("newcell"))


def _python(copy, code: str, timeout: float) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, cwd=copy, env=env)


def _last(out: subprocess.CompletedProcess):
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_only_new_files_and_entries(copy):
    for path in (ROOT / "gpubench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(ROOT)
            assert (copy / rel).read_bytes() == path.read_bytes(), rel
    old = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = json.loads((copy / "BENCHMARK.json").read_text())
    added = json.loads((toycell.FILES / toycell.ENTRIES).read_text())
    assert set(new) == set(old) and set(added) <= set(old)
    for key, value in old.items():
        assert new[key] == (value + added[key] if key in added else value), key


def test_copy_passes_its_cell_tests(copy):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
                          "gpubench/tests/test_bench_cells.py"], capture_output=True, text=True,
                         timeout=120, cwd=copy, env=env)
    assert out.returncode == 0, out.stdout[-3000:]
    for cell in ("toy.one", "toy.four"):
        assert f"test_cell_resolves[{cell}] PASSED" in out.stdout


_RUN = """
import json, sys
sys.path[:0] = ["gpubench/tests"]
import smoke, torch
from gpubench import run
out = run.run_cell(smoke.smoke_cell({cell!r}), {seed}, 0.3, {trace}, torch.device("cpu"))
print(json.dumps(out))
"""


@pytest.mark.parametrize("cell,trace,ranks", [("toy.one", False, 1), ("toy.four", True, 2)])
def test_toy_cell_runs(copy, cell, trace, ranks):
    got = _last(_python(copy, _RUN.format(cell=cell, seed=2**33 + 11, trace=trace), 120))
    assert got["correct"] and got["checks"] == {"sum_err": {"value": 0.0, "limit": 0.0}}
    assert got["attempted"] >= 1
    assert got["device"]["count"] == ranks
    assert len(got["device"]["memory_peak_bytes_by_rank"]) == ranks
    if trace:
        assert {"busy_s", "window_s"} <= set(got["device"]) and "breakdown" in got
    else:
        assert set(got["metrics"]) == {"setup_s", "toy_units_per_s"}


_FAULT = """
import json, sys
sys.path[:0] = ["gpubench/tests"]
import smoke, torch
from gpubench import calibrate
cell = smoke.smoke_cell("toy.four")
print(json.dumps([calibrate.readings(cell, 2**31 + 5, 3, torch.device("cpu"), fault=f)["program"]
                  for f in (None, "dropped")]))
"""


def test_calibrate_finds_a_new_drivers_faults(copy):
    """The toy driver's own ``FAULTS`` entry, planted on both ranks, leaves
    the exchange out: the sum misses the other rank's share."""
    sound, dropped = _last(_python(copy, _FAULT, 120))
    assert sound == {"sum_err": 0.0}
    assert dropped["sum_err"] > 0
