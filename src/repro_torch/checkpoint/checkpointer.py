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
  own) with the target's dtype, reading one leaf at a time.
* **the training mesh**: ``save(..., shardings=)`` (the state's
  ``sharding.train_state_shardings``, inside ``use_mesh``) gathers each leaf
  whole from its shards, one leaf at a time, and the mesh's first rank
  writes them all into ``host_0.npz`` with the manifest: the reference's
  format, so either package restores a mesh checkpoint on one device.
  Every rank passes a barrier before a synchronous ``save`` and before
  ``wait()`` return.  ``restore(..., shardings=)`` reads each whole leaf
  and keeps this rank's shard: the mesh may differ from the one that
  saved (the elastic path), and a one-device checkpoint restores onto
  a mesh.
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


def _active_mesh():
    from repro_torch.parallel import sharding

    ctx = sharding.active()
    if ctx is None:
        raise RuntimeError("shardings= needs the training mesh active (sharding.use_mesh)")
    return ctx.mesh


def _is_first(mesh) -> bool:
    return mesh.rank == int(mesh.devices.reshape(-1)[0])


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
        self._mesh = None
        os.makedirs(cfg.directory, exist_ok=True)

    # ------------------------------------------------------------- save

    def save(self, step: int, tree, extra: Optional[Dict[str, Any]] = None, *,
             shardings=None):
        """Snapshot + async write.  ``extra`` is JSON metadata (e.g. the
        data-pipeline DataState).  ``shardings``: ``tree`` holds this
        rank's shards on the active training mesh (module docstring);
        every rank of the mesh calls ``save``."""
        self.wait()
        mesh = None
        if shardings is not None:
            mesh = _active_mesh()
            by_path = dict(flatten_with_paths(shardings))
            writer = _is_first(mesh)
            # one leaf gathered at a time; only the first rank keeps it
            arrays = {}
            for k, v in flatten_with_paths(tree):
                full = by_path[k].gather(v, mesh)
                if writer:
                    arrays[k] = _to_host(k, full)
                del full
        else:
            # Snapshot to host memory *now*: the train step updates in place.
            arrays = {k: _to_host(k, v) for k, v in flatten_with_paths(tree)}
        self._mesh = mesh
        if mesh is not None and not _is_first(mesh):
            if not self.cfg.async_save:
                mesh.barrier()
            return
        manifest = {
            "step": int(step),
            "num_hosts": 1 if mesh is not None else self.num_hosts,
            "leaves": sorted(arrays),
            "extra": extra or {},
            "format": 1,
        }
        host = 0 if mesh is not None else self.host_id
        if self.cfg.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, arrays, manifest, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, arrays, manifest, host)
            if mesh is not None:
                mesh.barrier()

    def _write(self, step: int, arrays: Dict[str, np.ndarray],
               manifest: Dict[str, Any], host: int):
        try:
            final = self._step_dir(step)
            tmp = final + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, f"host_{host}.npz"), "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            if host == 0:
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
        """Join the writer (and, after a mesh save, meet every rank of the
        mesh); raise what the writer raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        mesh, self._mesh = self._mesh, None
        if mesh is not None and self.cfg.async_save:
            mesh.barrier()
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
        on ``device``, by default the target leaf's own.  ``shardings``
        (the whole state's ``sharding.train_state_shardings``, inside
        ``use_mesh``): ``target_tree`` holds this rank's shards and each
        whole leaf is sliced to its shard (module docstring)."""
        d = self._step_dir(step)
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        files = [np.load(os.path.join(d, name)) for name in sorted(os.listdir(d))
                 if name.startswith("host_") and name.endswith(".npz")]
        where = {k: z for z in files for k in z.files}
        mesh = _active_mesh() if shardings is not None else None
        by_path = dict(flatten_with_paths(shardings)) if shardings is not None else {}

        # Older checkpoints named container fields with a leading dot
        # ("w/.q"); current naming is dotless ("w/q").  Restore both.
        legacy = {"/".join(seg.lstrip(".") for seg in k.split("/")): k
                  for k in where if "/." in k}

        def leaf(key, ref):
            path = key
            if key not in where and key in legacy:
                key = legacy[key]
            if key not in where:
                raise KeyError(f"checkpoint {d} is missing leaf {key!r}")
            arr = where[key][key]
            want = by_path[path].shape if mesh is not None else tuple(ref.shape)
            if tuple(arr.shape) != tuple(want):
                raise ValueError(
                    f"leaf {key!r}: checkpoint shape {arr.shape} != "
                    f"target {tuple(want)}")
            if mesh is not None:
                from repro_torch.parallel.sharding import shard_leaf
                arr = shard_leaf(torch.from_numpy(arr), by_path[path].spec, mesh).numpy()
            return _from_host(arr, ref, ref.device if device is None else device)

        try:
            return map_with_paths(leaf, target_tree), manifest.get("extra", {})
        finally:
            for z in files:
                z.close()

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
