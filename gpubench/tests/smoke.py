"""Each cell of ``BENCHMARK.json`` at a size the CPU runs in seconds: the
same files, with the configuration and the traffic cut by the cell's
smoke file, ``gpubench/smoke/<cell>.json``:

* ``config``, ``traffic``: the keys that shrink the cell (each replaces
  the key of the cell's own file);
* ``suffix``: the suffix of the cell's per-layer metrics;
* ``span_calls``: the calls of each program span a unit makes at that
  size (``test_bench_spans_gpu.py``);
* ``ranks``: for a cell on more than one chip, the ranks its smoke run
  uses (gloo ranks on the CPU);
* ``why``: what the cut keeps.
"""

from __future__ import annotations

import copy
import json
import pathlib
import sys
from typing import Any, Dict

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from gpubench import harness  # noqa: E402

CELLS = tuple(w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])


def smoke_file(name: str) -> pathlib.Path:
    return harness.HERE / "smoke" / f"{name}.json"


def smoke(name: str) -> Dict[str, Any]:
    """Cell ``name``'s smoke file."""
    path = smoke_file(name)
    if not path.is_file():
        raise FileNotFoundError(f"cell {name!r} has no smoke file {path}")
    return json.loads(path.read_text())


def smoke_cell(name: str) -> harness.Cell:
    """Cell ``name`` with its configuration and traffic cut to smoke size
    (and its ranks to the smoke file's ``ranks``)."""
    cut = smoke(name)
    cell = copy.deepcopy(harness.find_cell(name))
    cell.config.update(cut["config"])
    cell.traffic.update(cut["traffic"])
    if cell.chips > 1:
        cell.chips = cut["ranks"]
    return cell
