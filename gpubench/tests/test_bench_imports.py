"""No module the benchmark's process loads has the top-level name of JAX or
the JAX package (compared whole: the port is ``repro_torch``), and the
references load nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from smoke import CELLS, ROOT

_RUN = """
import json, sys
sys.path[:0] = [{tests!r}]
import smoke, torch
from gpubench import harness, run
run.run_cell(smoke.smoke_cell({cell!r}), 5, 0.1, False, torch.device("cpu"))
print(json.dumps(harness.forbidden_modules()))
"""

_REFS = """
import json, sys
sys.path[:0] = [{root!r}]
from gpubench import harness
for config in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["configs"]:
    harness.load_module("reference", config["name"])
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("repro_torch", "jax", "jaxlib", "repro"))))
"""


def _last_line(code: str):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_run_loads_no_jax(cell):
    assert _last_line(_RUN.format(tests=str(ROOT / "gpubench" / "tests"), cell=cell)) == []


def test_references_load_nothing_of_the_program():
    assert _last_line(_REFS.format(root=str(ROOT))) == []


def test_forbidden_names_compared_whole(monkeypatch):
    from gpubench import harness

    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "reproduce", sys)
    assert "repro_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.kernels", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"repro.kernels", "jax.numpy"} <= set(harness.forbidden_modules())


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints no line
    (this container has none)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
