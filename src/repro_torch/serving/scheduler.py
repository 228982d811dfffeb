"""Continuous-batching scheduler: the host-side state machine the Engine
delegates to.

Counterpart of ``repro/serving/scheduler.py``; the same states, the same
order of events in a tick and the same fault points, so a scripted
timeline (a fake clock, a fault plan) resolves every request with the
same status as the reference.  Two strategies share one slot model
(queue -> slot -> result):

* :class:`BucketScheduler` — dense slab caches: a free slot admits ONE
  request per tick by running its whole prompt through ``prefill`` at
  the next bucket length (left-padded, pad positions poisoned) and
  copying the row's caches into its batch row, in place (the
  reference's ``dynamic_update_slice``);
* :class:`ChunkedScheduler` — paged caches: admission is free, prompts
  advance ``prefill_chunk`` tokens per tick through ONE batched
  ``chunk_step`` shared by every prefilling slot (per-row ``(start, n)``
  rows), interleaved with one ``serve_step`` for the decoding slots.
  Pages are allocated and reclaimed on the host through the per-entry
  :class:`~repro_torch.models.paged_kvcache.EntryPager`s and written in
  place on the device.

Slot lifecycle (chunked)::

    queued --admit--> PREFILL --chunks done--> DECODE --eos/max/evict--> free
       |                 |                        |
       +--- deadline/cancel() -> Result(status="expired"/"cancelled"),
            pages reclaimed, positions poisoned (reset_pages)

Every tick runs at most two forwards: one (B, prefill_chunk) chunk and
one (B, 1) decode.  A decode tick reads the sampled tokens and the
NaN/Inf guard's verdict back to the host in one transfer.

On a mesh engine every rank runs its own scheduler over the same
requests, and every projection of a forward is a collective: the ranks
must take the same decisions tick by tick, or a collective pairs with the
wrong one.  So each tick starts with one all-reduce of a digest of the
scheduler's state (queue, slots, positions, last tokens, results) and
raises ``launch.mesh.MeshDesyncError`` on disagreement, and every clock
reading (deadlines, backoff) is the first rank's, broadcast.  A rank that
diverges anyway (a fault plan armed on one rank only) stops at the next
digest, or at the group's collective timeout, never in a hang.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import paged_kvcache as paged
from repro_torch.models.kvcache import INVALID_POS
from repro_torch.resilience import faults

__all__ = ["Request", "Result", "Scheduler", "BucketScheduler",
           "ChunkedScheduler"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int token ids
    max_new_tokens: int = 32
    # Absolute deadline on the engine's clock (time.monotonic unless the
    # engine was built with an injected clock); None = wait forever.
    deadline: Optional[float] = None
    cancelled: bool = False
    # Preemption bookkeeping: how often this request was bumped from a
    # slot (page exhaustion), and the engine-clock instant before which
    # admission must not retry it (capped exponential backoff).
    retries: int = 0
    not_before: Optional[float] = None

    def cancel(self) -> None:
        """Withdraw the request: evicted (queued or running) on the next
        scheduler tick with ``Result.status == "cancelled"``."""
        self.cancelled = True


@dataclasses.dataclass
class Result:
    uid: int
    tokens: List[int]
    # "ok" | "expired" | "cancelled" | "rejected" (backpressure /
    # overlong prompt — never ran) | "numeric_error" (NaN/Inf logits
    # quarantine) | "error" (step exception quarantine).  Every
    # submitted request ends in exactly one.
    status: str = "ok"


def _tree_set_row(tree, row_tree, b: int) -> None:
    """Copy ``row_tree`` (batch 1 on dim 1) into batch row ``b`` of
    ``tree``, in place.  Cache leaves are (P, B, ...), rows (P, 1, ...)."""
    if isinstance(tree, dict):
        for k in tree:
            _tree_set_row(tree[k], row_tree[k], b)
    elif isinstance(tree, (list, tuple)):
        for full, row in zip(tree, row_tree):
            _tree_set_row(full, row, b)
    else:
        tree[:, b].copy_(row_tree[:, 0])


def _host_rows(logits: torch.Tensor, guard: bool):
    """(argmax per row, all-finite per row) of (R, V) logits, read back
    to the host in one transfer; the second is None without ``guard``."""
    nxt = logits.argmax(dim=-1)
    if not guard:
        return nxt.tolist(), None
    both = torch.stack([nxt, torch.isfinite(logits).all(dim=-1).to(nxt.dtype)]).tolist()
    return both[0], [bool(f) for f in both[1]]


class Scheduler:
    """Shared slot state + request lifecycle; subclasses supply the
    prefill/decode device work.  The engine is duck-typed: the scheduler
    reads and writes ``eng.params``, ``eng.caches``, ``eng.generator``
    and calls its step functions."""

    def __init__(self, engine, clock=None):
        self.eng = engine
        self.mesh = engine.scfg.mesh
        clock = clock or time.monotonic
        self.clock = clock if self.mesh is None else (lambda: self.mesh.from_first(clock()))
        b = engine.scfg.num_slots
        self.queue: deque = deque()
        self.slot_uid: List[int] = [-1] * b            # -1 = free
        self.slot_pos = np.zeros(b, np.int32)          # next write position
        self.slot_remaining = np.zeros(b, np.int32)
        self.slot_tokens: List[List[int]] = [[] for _ in range(b)]
        self.last_token = np.zeros(b, np.int64)
        self.slot_req: List[Optional[Request]] = [None] * b
        self.results: Dict[int, Result] = {}
        # uid -> [pre-sampling logits row per step] when the engine was
        # built with ServeConfig.trace_logits (None otherwise).
        self.logit_trace: Optional[Dict[int, List[np.ndarray]]] = (
            {} if engine.scfg.trace_logits else None)

    # ------------------------------------------------------------ lifecycle

    def submit(self, req: Request) -> None:
        scfg = self.eng.scfg
        if scfg.max_queue is not None and len(self.queue) >= scfg.max_queue:
            # Backpressure: the request never enters the system; a
            # definite Result is still minted.
            self._reject(req)
            return
        self.queue.append(req)
        self.eng.obs.on_submit(req.uid)

    def step(self) -> bool:
        """One tick: expire/cancel, admit+prefill, decode.  Returns True
        while any request is queued or in flight."""
        if self.mesh is not None:
            self.mesh.agree(self._digest(), "the scheduler state at the start of a tick")
        self.expire()
        faults.maybe_stall("step.stall")
        self.admit_once()
        # Fired between admission and decode so in-flight slots exist
        # when the loss lands.
        faults.maybe_raise("device.loss")
        self.decode_once()
        self.eng.obs.tick(len(self.queue), sum(1 for u in self.slot_uid if u != -1),
                          self.page_stats())
        return bool(self.queue or any(u != -1 for u in self.slot_uid))

    def page_stats(self) -> List:
        return []                 # paged schedulers override

    def _digest(self) -> List[int]:
        """The state every rank of a mesh must share, as integers."""
        return ([len(self.queue)] + [r.uid for r in self.queue] + list(self.slot_uid)
                + self.slot_pos.tolist() + self.last_token.tolist()
                + [len(self.results)])

    def expire(self) -> None:
        """Evict cancelled / past-deadline requests — queued ones before
        they touch a slot, running ones with their partial tokens — and
        reclaim what they hold."""
        now: Optional[float] = None
        kept: deque = deque()
        for req in self.queue:
            status = self._dead_status(req, now)
            if status is None:
                kept.append(req)
            else:
                self.results[req.uid] = Result(req.uid, [], status=status)
                self.eng.obs.on_queue_drop(req.uid, status)
        self.queue = kept
        for b in range(len(self.slot_uid)):
            if self.slot_uid[b] == -1:
                continue
            status = self._dead_status(self.slot_req[b], now)
            if status is not None:
                self.finish(b, status=status)

    def _dead_status(self, req: Request, now) -> Optional[str]:
        if req.cancelled:
            return "cancelled"
        if req.deadline is not None:
            if now is None:
                now = self.clock()
            if now > req.deadline:
                return "expired"
        return None

    def finish(self, b: int, status: str = "ok") -> None:
        self.results[self.slot_uid[b]] = Result(self.slot_uid[b], self.slot_tokens[b],
                                                status=status)
        self.eng.obs.on_finish(self.slot_uid[b], status, len(self.slot_tokens[b]))
        self.slot_uid[b] = -1
        self.slot_tokens[b] = []
        self.slot_req[b] = None
        self.release(b)

    def release(self, b: int) -> None:          # pages, in the paged case
        pass

    def trace(self, uid: int, row: torch.Tensor) -> None:
        if self.logit_trace is not None:
            self.logit_trace.setdefault(uid, []).append(
                row.detach().to(torch.float32).cpu().numpy().copy())

    # ------------------------------------------------------- degradation

    def _reject(self, req: Request) -> None:
        """Resolve a request as "rejected" without it ever holding a slot
        or a page (queue overflow, overlong prompt)."""
        self.results[req.uid] = Result(req.uid, [], status="rejected")
        self.eng.obs.on_queue_drop(req.uid, "rejected")

    def _pop_ready(self) -> Optional[Request]:
        """Pop the first queued request whose backoff window has passed;
        requests still inside ``not_before`` rotate to the back."""
        now: Optional[float] = None
        for _ in range(len(self.queue)):
            req = self.queue[0]
            if req.not_before is not None:
                if now is None:
                    now = self.clock()
                if now < req.not_before:
                    self.queue.rotate(-1)
                    continue
                req.not_before = None
            return self.queue.popleft()
        return None

    def preempt(self, b: int, cause: str = "page_exhausted") -> None:
        """Bump slot ``b``'s request back to the queue (no Result): pages
        are reclaimed now and admission retries it after a capped
        exponential backoff; a retried request replays from its prompt."""
        scfg = self.eng.scfg
        req = self.slot_req[b]
        req.retries += 1
        delay = min(scfg.retry_backoff_s * (2 ** (req.retries - 1)), scfg.retry_backoff_cap_s)
        req.not_before = self.clock() + delay
        self.eng.obs.on_preempt(req.uid, cause, req.retries, delay)
        self.slot_uid[b] = -1
        self.slot_tokens[b] = []
        self.slot_req[b] = None
        self.release(b)
        self.queue.append(req)

    def quarantine(self, exc: BaseException) -> None:
        """Containment for a step() that raised (``Engine.run``): every
        in-flight request resolves as "error" and its pages come back."""
        in_flight = sum(1 for u in self.slot_uid if u != -1)
        self.eng.obs.on_step_error(exc, in_flight)
        for b in range(len(self.slot_uid)):
            if self.slot_uid[b] != -1:
                self.finish(b, status="error")

    def shutdown(self) -> None:
        """Engine.close() path: release every occupied slot's resources
        without minting Results."""
        for b in range(len(self.slot_uid)):
            if self.slot_uid[b] != -1:
                self.slot_uid[b] = -1
                self.slot_tokens[b] = []
                self.slot_req[b] = None
                self.release(b)

    def _decode_rows(self, rows: List[int], step: np.ndarray, path: str) -> None:
        """One serve_step for ``rows`` at positions ``step`` (B,), then
        the NaN guard, the logit trace and the per-slot bookkeeping."""
        eng, scfg = self.eng, self.eng.scfg
        dev = eng.device
        toks = torch.from_numpy(np.where(step >= 0, self.last_token, 0)[:, None]).to(dev)
        nxt, last_logits, eng.caches = eng.serve_step(
            eng.params, eng.caches, toks, torch.from_numpy(step).to(dev), eng.generator)
        if faults.fire("logits.nan", op="decode", path=path):
            last_logits[rows[0]] = float("nan")
        if scfg.numeric_guard:
            both = torch.stack([nxt, torch.isfinite(last_logits).all(-1).to(nxt.dtype)])
            nxt_h, fin = both.tolist()
        else:
            nxt_h, fin = nxt.tolist(), None
        for b in rows:
            self.trace(self.slot_uid[b], last_logits[b])
        for b in rows:
            if fin is not None and not fin[b]:
                # poisoned logits: resolve the stream instead of emitting
                # NaN-derived tokens
                self.finish(b, status="numeric_error")
                continue
            self.slot_tokens[b].append(int(nxt_h[b]))
            self.last_token[b] = nxt_h[b]
            self.slot_pos[b] += 1
            self.slot_remaining[b] -= 1
            eng.obs.on_decode_token(self.slot_uid[b])
            if (self.slot_remaining[b] <= 0 or int(nxt_h[b]) == scfg.eos_id
                    or self.slot_pos[b] >= scfg.max_len):
                self.finish(b)

    def unfinished(self) -> List[Request]:
        """Queued plus in-flight requests, admission order first: what
        ``Engine.rebuild_after_loss`` migrates to the replacement."""
        out = list(self.queue)
        out.extend(r for r in self.slot_req if r is not None)
        return out

    def admit_once(self) -> None:
        raise NotImplementedError

    def decode_once(self) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Dense path: bucket prefill, one prompt per tick per free slot
# ---------------------------------------------------------------------------

class BucketScheduler(Scheduler):
    """Admit-by-bucket-prefill over dense slab caches."""

    def admit_once(self) -> None:
        eng = self.eng
        for b in range(eng.scfg.num_slots):
            if self.slot_uid[b] != -1:
                continue
            req = self._pop_ready()
            if req is None:
                break
            prompt = np.asarray(req.prompt, np.int64).reshape(-1)
            if len(prompt) > eng._buckets()[-1]:
                self._reject(req)
                continue
            eng.obs.on_admit(req.uid)
            # Claim the slot before any device work, so a prefill that
            # raises still resolves through quarantine().
            self.slot_uid[b] = req.uid
            self.slot_req[b] = req
            self.slot_tokens[b] = []
            bucket = next(s for s in eng._buckets() if s >= len(prompt))
            padded = np.zeros(bucket, np.int64)
            padded[bucket - len(prompt):] = prompt      # right-aligned, left pad 0s
            row_caches = eng._prefill_caches[bucket]
            logits, row_caches = eng.prefill(
                eng.params, row_caches, {"tokens": torch.from_numpy(padded[None]).to(eng.device)})
            # Left-pad slots must never be attended: poison their cache
            # positions so the `pos <= step` mask rejects them (SSM archs
            # have no position mask: serve those with prompts of a
            # bucket's length).
            pad = bucket - len(prompt)
            if pad:
                for c in row_caches:
                    if isinstance(c, dict) and "pos" in c:
                        c["pos"][:, :, :pad] = INVALID_POS
            for full, row in zip(eng.caches, row_caches):
                _tree_set_row(full, row, b)
            self.slot_pos[b] = bucket
            self.slot_remaining[b] = min(req.max_new_tokens, eng.scfg.max_len - bucket)
            lg_row = logits[0, -1]
            eng.obs.on_prefill_tokens(len(prompt))
            (first,), fin = _host_rows(lg_row[None], eng.scfg.numeric_guard)
            if fin is not None and not fin[0]:
                self.finish(b, status="numeric_error")
                continue
            self.trace(req.uid, lg_row)
            self.slot_tokens[b] = [first]
            self.last_token[b] = first
            eng.obs.on_first_token(req.uid)

    def decode_once(self) -> None:
        live = [b for b in range(self.eng.scfg.num_slots) if self.slot_uid[b] != -1]
        if live:
            self._decode_rows(live, self.slot_pos.copy(), "bucket")


# ---------------------------------------------------------------------------
# Paged path: chunked prefill interleaved with decode
# ---------------------------------------------------------------------------

class ChunkedScheduler(Scheduler):
    """Per-tick continuous batching over paged (tnn2 / oracle) caches."""

    def __init__(self, engine, clock=None):
        super().__init__(engine, clock)
        b = engine.scfg.num_slots
        self.pagers = paged.make_pagers(engine.caches, b)
        self.slot_prompt: List[Optional[np.ndarray]] = [None] * b
        self.slot_done = np.zeros(b, np.int32)   # prompt tokens processed
        self.slot_phase: List[str] = ["free"] * b

    # ------------------------------------------------------------- pages

    def release(self, b: int) -> None:
        self.slot_phase[b] = "free"
        self.slot_prompt[b] = None
        for i, pg in enumerate(self.pagers):
            if pg is None:
                continue
            pids = pg.release(b)
            if pids:
                paged.reset_pages(self.eng.caches[i], pids)

    def _ensure(self, b: int, hi: int) -> None:
        for pg in self.pagers:
            if pg is not None:
                pg.ensure(b, hi)

    def _sync(self) -> None:
        self.eng.caches = paged.sync_page_tables(self.eng.caches, self.pagers)

    def page_stats(self) -> List[Optional[Dict[str, int]]]:
        return [pg.stats() if pg is not None else None for pg in self.pagers]

    # --------------------------------------------------------- admission

    def admit_once(self) -> None:
        scfg = self.eng.scfg
        for b in range(scfg.num_slots):
            if self.slot_uid[b] != -1:
                continue
            req = self._pop_ready()
            if req is None:
                break
            prompt = np.asarray(req.prompt, np.int64).reshape(-1)
            if len(prompt) >= scfg.max_len:
                # needs room to decode at least one token
                self._reject(req)
                continue
            self.eng.obs.on_admit(req.uid)
            self.slot_uid[b] = req.uid
            self.slot_req[b] = req
            self.slot_prompt[b] = prompt
            self.slot_done[b] = 0
            self.slot_pos[b] = 0
            self.slot_tokens[b] = []
            self.slot_phase[b] = "prefill"
        self._prefill_round()

    def _prefill_round(self) -> None:
        eng, scfg = self.eng, self.eng.scfg
        chunk = scfg.prefill_chunk
        rows = [b for b in range(scfg.num_slots) if self.slot_phase[b] == "prefill"]
        if not rows:
            return
        toks = np.zeros((scfg.num_slots, chunk), np.int64)
        step2 = np.zeros((scfg.num_slots, 2), np.int32)
        live = []
        for b in rows:
            done = int(self.slot_done[b])
            n = min(chunk, len(self.slot_prompt[b]) - done)
            try:
                self._ensure(b, done + n)
            except paged.PagePoolExhausted:
                self.preempt(b, "page_exhausted")
                continue
            toks[b, :n] = self.slot_prompt[b][done:done + n]
            step2[b] = (done, n)
            live.append(b)
        rows = live
        if not rows:
            return
        self._sync()
        logits, eng.caches = eng.chunk_step(eng.params, eng.caches,
                                            torch.from_numpy(toks).to(eng.device),
                                            torch.from_numpy(step2).to(eng.device))
        if faults.fire("logits.nan", op="prefill", path="chunked"):
            b0 = rows[0]
            logits[b0, int(step2[b0, 1]) - 1] = float("nan")
        done_rows = []
        for b in rows:
            n = int(step2[b, 1])
            self.slot_done[b] += n
            eng.obs.on_prefill_tokens(n)
            if self.slot_done[b] >= len(self.slot_prompt[b]):
                done_rows.append(b)
        if not done_rows:
            return
        # prompt fully consumed: the greedy first token from the last
        # real chunk position (the bucket path's argmax)
        last = logits[done_rows, [int(step2[b, 1]) - 1 for b in done_rows]]
        firsts, fin = _host_rows(last, scfg.numeric_guard)
        for i, b in enumerate(done_rows):
            if fin is not None and not fin[i]:
                self.finish(b, status="numeric_error")
                continue
            plen = len(self.slot_prompt[b])
            self.trace(self.slot_uid[b], last[i])
            self.slot_phase[b] = "decode"
            self.slot_pos[b] = plen
            self.slot_remaining[b] = min(self.slot_req[b].max_new_tokens, scfg.max_len - plen)
            self.slot_tokens[b] = [firsts[i]]
            self.last_token[b] = firsts[i]
            eng.obs.on_first_token(self.slot_uid[b])
            if self.slot_remaining[b] <= 0:
                self.finish(b)

    # ------------------------------------------------------------ decode

    def decode_once(self) -> None:
        scfg = self.eng.scfg
        rows = [b for b in range(scfg.num_slots) if self.slot_phase[b] == "decode"]
        if not rows:
            return
        step = np.full(scfg.num_slots, -1, np.int32)
        live = []
        for b in rows:
            try:
                self._ensure(b, int(self.slot_pos[b]) + 1)
            except paged.PagePoolExhausted:
                self.preempt(b, "page_exhausted")
                continue
            step[b] = self.slot_pos[b]
            live.append(b)
        if not live:
            return
        self._sync()
        self._decode_rows(live, step, "chunked")
