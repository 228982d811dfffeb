"""The ranks of a cell that asks for more than one chip.

The process that runs the cell is rank 0.  Before the cell's driver is
built, :func:`lead` starts ``chips - 1`` followers (``gpubench/follow.py``
with the same ``--workload`` and ``--seed``), each with ``torchrun``'s
variables (``MASTER_ADDR`` 127.0.0.1, a free ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), and sets the same
variables for itself.  Nothing here opens a process group or imports the
program: each rank's driver joins the world through the program's own
entry.

Every rank builds the driver's ``Run(cell, seed, device)`` on its own
device (``cuda:<rank>``, or the CPU under gloo), then makes every call
rank 0 makes, in rank 0's order.  Rank 0 announces each call on a
control channel that is neither a process group nor device work: a
``torch.distributed.TCPStore`` on a second port, one key a call
(``call/<n>``).  Each follower acknowledges each call when it has made
it (``ack/<rank>``).  So the measured window and the profiled stretch
see the program's work and one store write a unit.  Only rank 0 times,
compares limits and prints, and only its trace feeds the per-layer
metrics.  Besides the driver's calls the followers make three of their
own: ``profile`` (open a profiler, before rank 0 opens its own for the
stretch), ``stretch`` (the stretch's units under it) and ``report``
(their peak device memory and the stretch's busy seconds, which the
result's ``busy_s`` averages over the ranks).

Teardown.  A follower exits when rank 0 announces the end, when rank 0's
process is gone, or when no call arrives within
:data:`FOLLOW_DEADLINE_S`.  Rank 0 watches the followers: one that exits
other than at the end, or acknowledges no call for :data:`ACK_DEADLINE_S`
after rank 0 announced it, fails the run with :class:`RankFailed`, and
every follower is killed.  Where rank 0's own thread stays inside the
program after that (a collective that waits for a rank that is gone),
it is given :data:`STUCK_GRACE_S` and then the process exits with
:data:`EXIT_STUCK` after printing what failed.  On every way out, each
follower's process group is killed and waited for; on a failure each
rank's log tail goes to standard error.

A one-chip cell starts no follower, opens no store and changes no
environment variable: :class:`Solo` hands every call straight to the
driver.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import os
import pathlib
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from gpubench import harness

HOST = "127.0.0.1"
# a follower that has acknowledged none of the calls rank 0 announced this
# long ago has failed
ACK_DEADLINE_S = 120.0
# after a failure, how long rank 0's thread may stay inside the program
# before the process exits
STUCK_GRACE_S = 20.0
# a follower that receives no call for this long exits (rank 0 hung)
FOLLOW_DEADLINE_S = 600.0
# how long the followers may take to leave once rank 0 announces the end
END_WAIT_S = 60.0
# rank 0's exit code where a failed rank leaves its thread stuck
EXIT_STUCK = 5
TAIL_BYTES = 4000
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                 "LOCAL_WORLD_SIZE")

__all__ = ["RankFailed", "Solo", "Leader", "lead", "follow", "HOST", "ACK_DEADLINE_S",
           "STUCK_GRACE_S", "FOLLOW_DEADLINE_S", "EXIT_STUCK"]


class RankFailed(RuntimeError):
    """A follower rank exited, or stopped acknowledging calls."""


class Solo:
    """A one-chip cell: every call goes straight to the driver."""

    def built(self) -> None:
        pass

    def unit(self, run):
        return run.step

    def call(self, run, name: str, *args):
        return getattr(run, name)(*args)

    def announce(self, name: str, *args) -> None:
        pass

    def settle(self, name: str) -> List[Dict[str, Any]]:
        return []

    def end(self) -> None:
        pass


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def _store(port: int, master: bool, timeout_s: float):
    from torch.distributed import TCPStore

    return TCPStore(HOST, port, is_master=master, wait_for_workers=False,
                    timeout=datetime.timedelta(seconds=timeout_s))


def _tail(path: pathlib.Path) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - TAIL_BYTES))
            return f.read().decode(errors="replace")
    except OSError as e:
        return f"(no log: {e})"


@dataclasses.dataclass
class _Follower:
    rank: int
    proc: subprocess.Popen
    log: pathlib.Path


class Leader:
    """Rank 0 of a cell on ``cell.chips`` ranks: starts the followers,
    announces each call, watches the followers and tears them down."""

    def __init__(self, cell: harness.Cell, seed: int, device, fault: Optional[str] = None):
        self.cell, self.seed, self.device, self.fault = cell, seed, device, fault
        self.world = cell.chips
        self.followers: List[_Follower] = []
        # the last call announced, and when each was (call 0: the driver
        # built, from when rank 0 waits for it)
        self.sent = 0
        self.sent_at: List[Optional[float]] = [None]
        self.failed: Optional[str] = None
        self.ending = False
        self._stop = threading.Event()
        self._left = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        self._saved_env: Dict[str, Optional[str]] = {}
        self._logs: Optional[pathlib.Path] = None
        self.store = None

    # -- start and stop ---------------------------------------------------

    def start(self) -> None:
        self.store = _store(0, True, FOLLOW_DEADLINE_S)
        control = self.store.port
        master = _free_port()
        self.store.set("cell", json.dumps(dataclasses.asdict(self.cell)))
        self.store.set("run", json.dumps({"device": self.device.type, "fault": self.fault}))
        for r in range(1, self.world):
            self.store.set(f"ack/{r}", json.dumps({"n": -1}))
        common = {"MASTER_ADDR": HOST, "MASTER_PORT": str(master),
                  "WORLD_SIZE": str(self.world), "LOCAL_WORLD_SIZE": str(self.world)}
        for k in _TORCHRUN_ENV:
            self._saved_env[k] = os.environ.get(k)
        os.environ.update(common, RANK="0", LOCAL_RANK="0")
        self._logs = pathlib.Path(tempfile.mkdtemp(prefix="gpubench_ranks_"))
        for r in range(1, self.world):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r))
            log = self._logs / f"rank{r}.log"
            with open(log, "wb") as f:
                proc = subprocess.Popen(
                    [sys.executable, str(harness.HERE / "follow.py"), "--workload",
                     self.cell.name, "--seed", str(self.seed), "--control", str(control)],
                    env=env, cwd=str(harness.ROOT), stdin=subprocess.DEVNULL, stdout=f,
                    stderr=subprocess.STDOUT, start_new_session=True)
            self.followers.append(_Follower(r, proc, log))
        self._watcher = threading.Thread(target=self._watch, args=(control,),
                                         name="gpubench-ranks", daemon=True)
        self._watcher.start()

    def close(self, report: bool) -> None:
        """Stop watching, kill every follower's process group and wait for
        it, print each rank's log tail where ``report``, and put the
        environment back."""
        self._left.set()
        self._stop.set()
        if self._watcher is not None:
            self._watcher.join()
        self._kill()
        if report:
            self.print_tails()
        for k, v in self._saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        self.store = None
        if self._logs is not None:
            shutil.rmtree(self._logs, ignore_errors=True)

    def _kill(self) -> None:
        for f in self.followers:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.killpg(f.proc.pid, signal.SIGKILL)
            with contextlib.suppress(subprocess.TimeoutExpired):
                f.proc.wait(timeout=30)

    def print_tails(self) -> None:
        for f in self.followers:
            print(f"gpubench: rank {f.rank} (exit code {f.proc.poll()}), end of its log:\n"
                  f"{_tail(f.log)}", file=sys.stderr, flush=True)

    # -- watching ---------------------------------------------------------

    def _exited(self) -> Optional[str]:
        """A follower that exited other than with 0 at the end, if any."""
        for f in self.followers:
            rc = f.proc.poll()
            if rc is not None and not (self.ending and rc == 0):
                return f"rank {f.rank} exited with code {rc} (at rank 0's call {self.sent})"
        return None

    def _look(self, store) -> Optional[str]:
        """What failed, if anything: a follower that exited, or one that
        has not acknowledged a call ACK_DEADLINE_S after it was announced."""
        exited = self._exited()
        if exited is not None:
            return exited
        now = time.monotonic()
        for f in self.followers:
            oldest = json.loads(store.get(f"ack/{f.rank}"))["n"] + 1
            if oldest <= self.sent and oldest < len(self.sent_at) \
                    and self.sent_at[oldest] is not None \
                    and now - self.sent_at[oldest] > ACK_DEADLINE_S:
                return (f"rank {f.rank} has not acknowledged call {oldest} "
                        f"{now - self.sent_at[oldest]:.0f} s after rank 0 announced it")
        return None

    def _watch(self, control: int) -> None:
        store = _store(control, False, 30.0)
        while not self._stop.wait(0.25):
            failed = self._look(store)
            if failed is None:
                continue
            self.failed = failed
            self._kill()
            if not self._left.wait(STUCK_GRACE_S):
                print(f"gpubench: {failed}; rank 0 is still inside the program "
                      f"{STUCK_GRACE_S:.0f} s later: exiting", file=sys.stderr, flush=True)
                self.print_tails()
                os._exit(EXIT_STUCK)
            return

    def _blame(self, error: BaseException) -> None:
        """Raise RankFailed from ``error`` where a follower failed: the
        error on rank 0 then follows from it (a peer gone from a
        collective).  A follower's exit can come a moment after the error
        it causes here, so look for a few seconds."""
        deadline = time.monotonic() + 3.0
        while True:
            if self.failed is None:
                self.failed = self._exited()
            if self.failed is not None:
                raise RankFailed(self.failed) from error
            if time.monotonic() > deadline:
                return
            time.sleep(0.1)

    # -- calls ------------------------------------------------------------

    def announce(self, name: str, *args) -> None:
        """Tell every follower to make call ``name(*args)`` next."""
        if self.failed is not None:
            raise RankFailed(self.failed)
        self.sent_at.append(time.monotonic())
        self.sent += 1
        self.store.set(f"call/{self.sent}", json.dumps([name, list(args)]))

    def call(self, run, name: str, *args):
        """Announce ``name(*args)``, then make it on rank 0's ``run``."""
        self.announce(name, *args)
        try:
            return getattr(run, name)(*args)
        except Exception as e:
            self._blame(e)
            raise

    def unit(self, run):
        """The window's step: each unit announced, then run."""
        def step(i: int) -> None:
            self.call(run, "step", i)
        return step

    def _acks(self, n: int) -> List[Dict[str, Any]]:
        """Wait until every follower has acknowledged call ``n``; their
        acknowledgements."""
        while True:
            if self.failed is not None:
                raise RankFailed(self.failed)
            acks = [json.loads(self.store.get(f"ack/{f.rank}")) for f in self.followers]
            if all(a["n"] >= n for a in acks):
                return acks
            time.sleep(0.005)

    def built(self) -> None:
        """Wait until every follower has built its driver's Run."""
        self.sent_at[0] = time.monotonic()
        self._acks(0)

    def settle(self, name: str) -> List[Dict[str, Any]]:
        """Announce one of the followers' own calls and wait until each has
        made it; their acknowledgements.  ``"profile"``: each opens its
        profiler on a card (before rank 0 profiles the stretch, whose
        ``"stretch"`` call the followers then run under it); ``"report"``:
        each one's peak device memory (``peak``) and the busy seconds of
        its last profiled stretch (``busy_s``, None where it profiled
        none)."""
        self.announce(name)
        return self._acks(self.sent)

    def end(self) -> None:
        """Announce the end and wait for every follower to exit with 0."""
        self.ending = True
        self.announce("end")
        deadline = time.monotonic() + END_WAIT_S
        for f in self.followers:
            try:
                rc = f.proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RankFailed(f"rank {f.rank} did not exit within {END_WAIT_S:.0f} s "
                                 f"of the end") from None
            if rc != 0:
                raise RankFailed(f"rank {f.rank} exited with code {rc} at the end")
        if self.failed is not None:
            raise RankFailed(self.failed)


@contextlib.contextmanager
def lead(cell: harness.Cell, seed: int, device, fault: Optional[str] = None) -> Iterator:
    """Rank 0's side of ``cell``'s run: a :class:`Solo` for one chip, else a
    started :class:`Leader`, torn down on every way out."""
    if cell.chips == 1:
        yield Solo()
        return
    leader = Leader(cell, seed, device, fault)
    ok = False
    try:
        leader.start()
        yield leader
        ok = True
    finally:
        leader.close(report=not ok)


# ---------------------------------------------------------------------------
# A follower
# ---------------------------------------------------------------------------

def _orphan_watch(parent: int) -> None:
    """Exit at once when rank 0's process is gone (this process is then
    another's child), even from inside a collective."""
    while True:
        time.sleep(0.5)
        if os.getppid() != parent:
            os._exit(3)


def follow(workload: str, seed: int, control: int) -> int:
    """Follower rank ``RANK``'s whole life: build the driver's Run, make
    each call rank 0 announces in order, and acknowledge each."""
    import torch

    threading.Thread(target=_orphan_watch, args=(os.getppid(),), daemon=True).start()
    rank = int(os.environ["RANK"])
    store = _store(control, False, FOLLOW_DEADLINE_S)
    cell = harness.Cell(**json.loads(store.get("cell")))
    if cell.name != workload:
        raise SystemExit(f"rank {rank}: rank 0 runs {cell.name!r}, not {workload!r}")
    how = json.loads(store.get("run"))
    cuda = how["device"] == "cuda"
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    drv = harness.load_module("drivers", cell.traffic["driver"])
    from gpubench import calibrate

    busy = prof = None
    with calibrate.plant(cell, how["fault"]):
        run = drv.Run(cell, seed, device)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        store.set(f"ack/{rank}", json.dumps({"n": 0}))
        n = 0
        while True:
            n += 1
            name, args = json.loads(store.get(f"call/{n}"))
            ack: Dict[str, Any] = {"n": n}
            if name == "end":
                store.set(f"ack/{rank}", json.dumps(ack))
                return 0
            if name == "profile":
                if cuda:
                    torch.cuda.synchronize(device)
                    prof = harness.profiler()
                    prof.start()
            elif name == "stretch":
                begin, units = args
                for i in range(begin, begin + units):
                    run.step(i)
                if prof is not None:
                    torch.cuda.synchronize(device)
                    prof.stop()
                    busy = harness.read_profile(prof, units, 0.0, 0.0, {}, 0).busy_s
                    prof = None
            elif name == "report":
                ack.update(peak=int(torch.cuda.max_memory_allocated(device)) if cuda else 0,
                           busy_s=busy)
            else:
                getattr(run, name)(*args)
            store.set(f"ack/{rank}", json.dumps(ack))
