"""``BENCHMARK.json`` against the benchmark's contract, and every cell
entry resolving to its files."""

from __future__ import annotations

import json
import re

import pytest

from smoke import CELLS, ROOT, smoke, smoke_file
from gpubench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["command"][0] == "python3"
    assert (ROOT / BENCH["command"][1]).is_file()
    assert BENCH["command"][1].startswith("gpubench/")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_cells_listed():
    assert [w["name"] for w in BENCH["workloads"]] == list(CELLS)
    assert len(set(CELLS)) == len(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    # at most a quarter of the cells, rounded down, on four chips; one always may
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in BENCH["workloads"]] + \
        [c["name"] for c in BENCH["configs"]]
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%", m
    for text in [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]] \
            + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]


def test_per_layer_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert harness.metric_reader(m["name"]).read is not None


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    """The cell's config, traffic, driver, reference, limits, readers and
    smoke file are found by the names in its entry, it asks for 1 or 4
    chips, and it reports ``setup_s``, one more end-to-end metric and a
    per-layer one."""
    cell = harness.find_cell(name)
    entry = {w["name"]: w for w in BENCH["workloads"]}[name]
    cfg = {c["name"]: c for c in BENCH["configs"]}[entry["config"]]
    assert cfg["file"].startswith("gpubench/") and (ROOT / cfg["file"]).is_file()
    assert cell.config["name"] == entry["config"]
    assert cell.config["reduced"] == cfg["reduced"]
    assert all(k in cell.config for k in cfg["reduced"])
    assert entry["chips"] in (1, 4)
    assert smoke_file(name).is_file(), f"{name} needs its smoke file {smoke_file(name)}"
    cut = smoke(name)
    assert {"config", "traffic", "suffix", "span_calls"} <= set(cut)
    assert all(m["name"].endswith("." + cut["suffix"]) for m in cell.per_layer
               if "." in m["name"])
    if entry["chips"] > 1:
        assert 2 <= cut["ranks"] <= entry["chips"]
    assert (harness.HERE / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert (harness.HERE / "reference" / f"{entry['config']}.py").is_file()
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        harness.metric_reader(m["name"])
    for lim in cell.limits.values():
        assert lim["limit"] >= 0
