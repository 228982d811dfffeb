"""Deterministic, resumable, host-sharded LM data pipeline.

Counterpart of ``repro/data/pipeline.py``: numpy only, so every batch is
bit-identical to the reference's; the trainer moves it to its device.
The dry-run's ``global_batch_spec`` comes with the dry-run slice.

Fault-tolerance posture (1000+ node jobs):

* the entire pipeline state is ``DataState(step, seed)`` — two integers.
  Checkpointing the trainer checkpoints the pipeline for free, and a
  restarted (possibly re-sized) job resumes *exactly*: batch contents
  are a pure function of (seed, step, global example index), never of
  host count or wall clock.
* each host materializes only its slice of the global batch
  (``host_rows``): example ``g`` of step ``t`` lands on the host that
  owns row ``g`` under the current mesh's "data"-axis layout, so elastic
  restarts with a different host count re-deal the same global batch.
* generation is cheap, seeded counter-mode hashing (a Philox-style mix of
  (seed, step, g, position)) — no host RNG state to snapshot and no I/O
  dependency, which is what a dry-runnable framework needs; a real corpus
  reader would slot in behind the same ``DataState`` contract by mapping
  (step, g) -> corpus offset.

The synthetic stream is *learnable* (a noisy order-2 Markov chain over
the vocab) so the end-to-end example's loss provably falls below the
uniform baseline — a real training signal, not white noise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["DataState", "SyntheticLM", "make_pipeline", "host_rows", "mesh_rows"]


@dataclasses.dataclass(frozen=True)
class DataState:
    """The whole pipeline state.  Serialize these two ints and you can
    resume the stream bit-exactly on any number of hosts."""
    step: int
    seed: int

    def next(self) -> "DataState":
        return DataState(self.step + 1, self.seed)


def _mix(*ints: np.ndarray) -> np.ndarray:
    """Counter-mode hash: deterministic uint64 mix of the inputs
    (wraparound is the point — silence the overflow warnings)."""
    with np.errstate(over="ignore"):
        h = np.uint64(0x9E3779B97F4A7C15)
        for x in ints:
            x = np.asarray(x, np.uint64)
            h = np.bitwise_xor(h, x + np.uint64(0x9E3779B97F4A7C15)
                               + (h << np.uint64(6)) + (h >> np.uint64(2)))
            h = h * np.uint64(0xBF58476D1CE4E5B9)
            h = np.bitwise_xor(h, h >> np.uint64(31))
        return h


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Noisy order-k Markov token stream.

    token[t] = f(token[t-1], ..., token[t-order]) with prob (1-noise),
    uniform otherwise; f is a fixed seeded hash.  Entropy is well below
    uniform, so cross-entropy has real headroom.  order=1 gives a
    V-entry transition table a small model learns in minutes (the
    examples); order=2 gives V^2 contexts (a capacity stressor).
    """
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1
    order: int = 2

    def batch_at(self, state: DataState,
                 rows: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Materialize rows ``rows`` (default: all) of step ``state.step``.

        Returns {"tokens": (R, S) int32, "labels": (R, S) int32,
        "mask": (R, S) f32}; labels are next-token shifted.
        """
        if rows is None:
            rows = np.arange(self.global_batch)
        rows = np.asarray(rows, np.uint64)
        s, v = self.seq_len, self.vocab_size
        step = np.uint64(state.step)
        seed = np.uint64(state.seed ^ self.seed)

        # +1 so labels are a pure shift of the same stream.
        toks = np.zeros((len(rows), s + 1), np.int64)
        for t in range(self.order):
            toks[:, t] = _mix(seed, step, rows, np.uint64(t)) % np.uint64(v)
        for t in range(self.order, s + 1):
            ctx = [toks[:, t - 1 - i].astype(np.uint64)
                   for i in range(self.order)]
            det = _mix(np.uint64(self.seed), *ctx) % np.uint64(v)
            r = _mix(seed, step, rows, np.uint64(2 * t))
            is_noise = (r % np.uint64(1000)) < np.uint64(int(self.noise * 1000))
            rnd = _mix(seed, step, rows, np.uint64(2 * t + 1)) % np.uint64(v)
            toks[:, t] = np.where(is_noise, rnd, det)

        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "mask": np.ones((len(rows), s), np.float32),
        }


def host_rows(global_batch: int, host_id: int, num_hosts: int) -> np.ndarray:
    """Contiguous row range owned by this host (data-axis major layout)."""
    per = global_batch // num_hosts
    rem = global_batch % num_hosts
    start = host_id * per + min(host_id, rem)
    return np.arange(start, start + per + (1 if host_id < rem else 0))


def mesh_rows(global_batch: int, coord: int, shards: int, microbatch: int = 1) -> np.ndarray:
    """The rows batch coordinate ``coord`` of ``shards`` owns on the
    training mesh: :func:`host_rows` of the global batch, or, with
    ``microbatch`` > 1, its :func:`host_rows` of each of the global batch's
    ``microbatch`` chunks in turn, so that the rank's ``i``-th microbatch
    holds its share of the global ``i``-th one (the rows the one-device
    step's ``i``-th microbatch holds).  Uneven shares are allowed for one
    microbatch only."""
    if microbatch == 1:
        return host_rows(global_batch, coord, shards)
    chunk = global_batch // microbatch
    if global_batch % microbatch or chunk % shards:
        raise ValueError(f"a global batch of {global_batch} does not split into "
                         f"{microbatch} microbatches of equal shares on {shards} shards")
    return np.concatenate([i * chunk + host_rows(chunk, coord, shards)
                           for i in range(microbatch)])


def make_pipeline(source: SyntheticLM, state: DataState, *,
                  host_id: int = 0, num_hosts: int = 1, microbatch: int = 1
                  ) -> Iterator[Tuple[DataState, Dict[str, np.ndarray]]]:
    """Yields (state_after, host_local_batch) forever, resumably: the rows
    of :func:`mesh_rows` (``host_id`` the batch coordinate, ``num_hosts``
    the batch shards)."""
    rows = mesh_rows(source.global_batch, host_id, num_hosts, microbatch)
    while True:
        batch = source.batch_at(state, rows)
        state = state.next()
        yield state, batch
