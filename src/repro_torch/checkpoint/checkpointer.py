"""Async, atomic checkpointing of the port's train state, in the
reference's on-disk format.

Counterpart of ``repro/checkpoint/checkpointer.py``.  Layout on disk
(one directory per step), the same as the reference's, so each package
restores the other's checkpoints:

    <dir>/step_000120/
        MANIFEST.json          step, data state, leaf index, format 1
        host_<h>.npz           this host's arrays, keyed by leaf path

Leaf paths are the reference's (:mod:`repro_torch.tree`): dict keys,
list indices and container fields joined by "/" — ``params/embed``,
``opt/m/blocks/0/attn/wq/w/q``, a packed ``wq/payload/plus``.

* **atomic**: a checkpoint is written under a ``.tmp`` name and renamed
  only after the host file and the fsynced manifest are in place — a
  job killed mid-save never leaves a half-written "latest".
* **async**: ``save()`` copies every leaf to host memory in the calling
  thread (``Tensor.to("cpu", copy=True)``; the train step then updates
  its tensors in place) and hands the arrays to a writer thread;
  ``wait()`` joins it and raises what it raised.
* **restore** puts each leaf on ``device`` (default: the target leaf's
  own) with the target's dtype.  ``shardings=`` re-shards onto a new
  mesh in the reference; it belongs to the port's training mesh, a later
  slice, and raises until then (the serving mesh re-packs raw weights).
* retention: the ``keep`` most recent checkpoints are kept; older ones
  are deleted only after the new save commits.

bfloat16 tensors have no numpy form without ``ml_dtypes``, which the
port does not depend on: ``save()`` refuses them rather than writing a
float32 copy under the same key.  Train state is float32 masters, int8
moments and float32 scales, so none reaches it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, map_with_paths

__all__ = ["CheckpointConfig", "Checkpointer", "save_tree", "restore_tree"]


def _to_host(key: str, v) -> np.ndarray:
    """A snapshot of leaf ``v`` as a numpy array that training cannot
    change afterwards."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            raise TypeError(
                f"leaf {key!r} is bfloat16, which has no numpy form here; "
                f"checkpoint the float32 master instead")
        return v.detach().to("cpu", copy=True).numpy()
    return np.array(v, copy=True)


def _from_host(arr: np.ndarray, ref: torch.Tensor, device) -> torch.Tensor:
    """``arr`` as a tensor of ``ref``'s dtype on ``device`` (numpy's cast,
    as the reference's ``astype``: uint32 planes wrap into int32)."""
    if ref.dtype == torch.bfloat16:
        return torch.from_numpy(arr.astype(np.float32)).to(device=device,
                                                           dtype=torch.bfloat16)
    np_dtype = torch.empty((), dtype=ref.dtype).numpy().dtype
    return torch.from_numpy(arr.astype(np_dtype, order="C")).to(device)


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    keep: int = 3
    async_save: bool = True


class Checkpointer:
    def __init__(self, cfg: CheckpointConfig, *, host_id: int = 0,
                 num_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(cfg.directory, exist_ok=True)

    # ------------------------------------------------------------- save

    def save(self, step: int, tree, extra: Optional[Dict[str, Any]] = None):
        """Snapshot + async write.  ``extra`` is JSON metadata (e.g. the
        data-pipeline DataState)."""
        self.wait()
        # Snapshot to host memory *now*: the train step updates in place.
        arrays = {k: _to_host(k, v) for k, v in flatten_with_paths(tree)}
        manifest = {
            "step": int(step),
            "num_hosts": self.num_hosts,
            "leaves": sorted(arrays),
            "extra": extra or {},
            "format": 1,
        }
        if self.cfg.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, arrays, manifest), daemon=True)
            self._thread.start()
        else:
            self._write(step, arrays, manifest)

    def _write(self, step: int, arrays: Dict[str, np.ndarray],
               manifest: Dict[str, Any]):
        try:
            final = self._step_dir(step)
            tmp = final + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, f"host_{self.host_id}.npz"), "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            if self.host_id == 0:
                with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                    json.dump(manifest, f, indent=1)
                    f.flush()
                    os.fsync(f.fileno())
            if not os.path.exists(final):
                os.replace(tmp, final)
            self._gc()
        except BaseException as e:   # surfaced on the next wait()
            self._error = e

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    # ---------------------------------------------------------- restore

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.cfg.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(
                    self.cfg.directory, name, "MANIFEST.json")):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore(self, step: int, target_tree, *, shardings=None, device=None
                ) -> Tuple[Any, Dict[str, Any]]:
        """-> (tree, extra).  ``target_tree`` supplies structure, shapes and
        dtypes (tensors, e.g. a freshly initialized state); each leaf lands
        on ``device``, by default the target leaf's own."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=...) re-shards onto a training mesh, which comes with "
                "the training-mesh slice of the port (ROADMAP.md, queue 1)")
        d = self._step_dir(step)
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        data: Dict[str, np.ndarray] = {}
        for name in sorted(os.listdir(d)):
            if name.startswith("host_") and name.endswith(".npz"):
                with np.load(os.path.join(d, name)) as z:
                    data.update({k: z[k] for k in z.files})

        # Older checkpoints named container fields with a leading dot
        # ("w/.q"); current naming is dotless ("w/q").  Restore both.
        legacy = {"/".join(seg.lstrip(".") for seg in k.split("/")): k
                  for k in data if "/." in k}

        def leaf(key, ref):
            if key not in data and key in legacy:
                key = legacy[key]
            if key not in data:
                raise KeyError(f"checkpoint {d} is missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"leaf {key!r}: checkpoint shape {arr.shape} != "
                    f"target {tuple(ref.shape)}")
            return _from_host(arr, ref, ref.device if device is None else device)

        return map_with_paths(leaf, target_tree), manifest.get("extra", {})

    # ------------------------------------------------------------- misc

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.cfg.directory, f"step_{step:06d}")

    def _gc(self):
        if self.host_id != 0:
            return
        steps = sorted(
            int(m.group(1)) for m in
            (re.fullmatch(r"step_(\d+)", n)
             for n in os.listdir(self.cfg.directory)) if m)
        for s in steps[:-self.cfg.keep] if self.cfg.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


# Convenience one-shot helpers ---------------------------------------------

def save_tree(directory: str, step: int, tree, extra=None):
    ck = Checkpointer(CheckpointConfig(directory, async_save=False))
    ck.save(step, tree, extra)
    ck.wait()


def restore_tree(directory: str, step: int, target_tree, shardings=None, device=None):
    ck = Checkpointer(CheckpointConfig(directory))
    return ck.restore(step, target_tree, shardings=shardings, device=device)
