"""The ranks of a cell on more than one chip (``gpubench/ranks.py``), on the
CPU with the toy cell ``toy.four`` of ``toycell.py`` on two gloo ranks
(one all-reduce a unit): the follower makes rank 0's calls in rank 0's
order and the result prints once; a follower that raises, or stops
acknowledging calls, fails the run within a minute, naming its rank;
rank 0 raising kills the follower; and no follower is left running
after any of these."""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest

import toycell
from smoke import ROOT

SRC = str(ROOT / "src")


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return toycell.make_copy(tmp_path_factory.mktemp("ranks"))


def _followers(copy) -> list:
    """The pids of the copy's followers still running."""
    script = str(copy / "gpubench" / "follow.py")
    pids = []
    for proc in pathlib.Path("/proc").iterdir():
        if not proc.name.isdigit():
            continue
        try:
            cmd = (proc / "cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        if script.encode() in cmd:
            pids.append(int(proc.name))
    return pids


def _python(copy, code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=copy, env=env)


# run.py's main, with the card's presence stubbed and the cell on the CPU
_MAIN = """
import sys
sys.path[:0] = ["gpubench/tests"]
import smoke, torch
from gpubench import run
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 4
real = run.run_cell


def on_cpu(cell, seed, seconds, trace, device, **kw):
    cut = smoke.smoke_cell(cell.name)
    cut.traffic.update({traffic!r})
    return real(cut, seed, seconds, trace, torch.device("cpu"), **kw)


run.run_cell = on_cpu
sys.exit(run.main(["--workload", "toy.four", "--seed", "3000000301", "--seconds", "0.3",
                   "--trace", "0"]))
"""


def test_follower_makes_rank0s_calls_and_one_result_prints(copy, tmp_path):
    out = _python(copy, _MAIN.format(traffic={"call_log": str(tmp_path)}))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1 and out.stdout.strip().splitlines()[-1].startswith("{")
    result = lines[0]
    assert result["correct"] and result["device"]["count"] == 2
    calls = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in (0, 1)]
    assert calls[0] == calls[1]
    steps = [c[1] for c in calls[0] if c[0] == "step"]
    assert len(steps) == 1 + result["attempted"]       # the warm-up unit and the window
    assert steps[1:] == list(range(1, 1 + result["attempted"]))
    assert calls[0][-2:] == [["release"], ["check"]]
    assert _followers(copy) == []


_RAISE = """
import json, sys, time
sys.path[:0] = ["gpubench/tests"]
import smoke, torch
from gpubench import ranks, run
ranks.ACK_DEADLINE_S = 3.0
cell = smoke.smoke_cell("toy.four")
cell.traffic.update({traffic!r})
t = time.perf_counter()
try:
    run.run_cell(cell, 3000000302, 30.0, False, torch.device("cpu"))
    print(json.dumps({{"raised": None}}))
except Exception as e:
    print(json.dumps({{"raised": type(e).__name__, "message": str(e),
                      "s": time.perf_counter() - t}}))
"""


def test_follower_raising_fails_the_run_naming_it(copy):
    out = _python(copy, _RAISE.format(traffic={"raise_at": [1, 20]}))
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["raised"] == "RankFailed" and "rank 1" in got["message"], got
    assert got["s"] < 60
    assert "toy fault on rank 1 at unit 20" in out.stderr     # the follower's log tail
    assert _followers(copy) == []


def test_rank0_raising_kills_the_follower(copy):
    out = _python(copy, _RAISE.format(traffic={"raise_at": [0, 20]}))
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["raised"] == "RuntimeError" and "rank 0 at unit 20" in got["message"], got
    assert got["s"] < 60
    assert _followers(copy) == []


def test_follower_that_stops_acknowledging_fails_the_run(copy):
    """A follower asleep in unit 20 (rank 0 waits in the all-reduce):
    past the acknowledgement deadline (3 s here) rank 0 kills it and the
    run fails, naming it."""
    out = _python(copy, _RAISE.format(traffic={"stall_at": [1, 20]}))
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["raised"] == "RankFailed" and "rank 1 has not acknowledged" in got["message"], got
    assert got["s"] < 60
    assert _followers(copy) == []
