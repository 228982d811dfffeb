"""The port's checkpointer (``repro_torch.checkpoint``) on the CPU: the
reference's single-device cases, run on the port, and the on-disk format
across packages — a train state written by the JAX package restores
into the port ``array_equal``, and one written by the port restores into
the JAX package ``array_equal`` (same leaf keys, same arrays).  The
reference's ``test_elastic_restore_new_shardings`` restores here onto
each position of a mesh (``shardings=``, no ranks needed: restoring
only slices); saving on a mesh of ranks is tested in
``test_torch_train_mesh.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointConfig as JCheckpointConfig
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_smoke as jget_smoke
from repro.models import common as jcommon
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.checkpoint import CheckpointConfig, Checkpointer, restore_tree, save_tree
from repro_torch.configs import get_smoke
from repro_torch.models.common import ShardLayout
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import Q8
from repro_torch.train import TrainStepConfig, init_train_state
from repro_torch.tree import flatten_with_paths


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((16, 8), generator=g),
                   "b": torch.zeros((8,))},
        "opt": {"step": torch.tensor(3, dtype=torch.int32),
                "m": {"w": Q8.quantize(torch.randn((16, 8), generator=g))}},
    }


def _assert_trees_equal(got, want):
    a, b = flatten_with_paths(got), flatten_with_paths(want)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype, k
        assert torch.equal(x, y), k


def test_roundtrip(tmp_path):
    ck = Checkpointer(CheckpointConfig(str(tmp_path), async_save=False))
    tree = _tree()
    ck.save(7, tree, extra={"data_state": {"step": 7, "seed": 0}})
    ck.wait()
    assert ck.latest_step() == 7
    restored, extra = ck.restore(7, _tree(seed=1))
    assert extra["data_state"]["step"] == 7
    _assert_trees_equal(restored, tree)


def test_async_save_then_wait(tmp_path):
    ck = Checkpointer(CheckpointConfig(str(tmp_path), async_save=True))
    tree = _tree()
    before = tree["params"]["w"].clone()
    ck.save(1, tree)
    tree["params"]["w"].add_(1.0)        # the snapshot was taken at save()
    ck.wait()
    assert ck.latest_step() == 1
    restored, _ = ck.restore(1, _tree(seed=1))
    assert torch.equal(restored["params"]["w"], before)


def test_async_error_surfaces_on_wait(tmp_path):
    ck = Checkpointer(CheckpointConfig(str(tmp_path / "ck"), async_save=True))
    os.rmdir(tmp_path / "ck")
    (tmp_path / "ck").write_text("not a directory")
    ck.save(1, _tree())
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        ck.wait()
    ck.wait()                            # raised once, then cleared


def test_atomic_no_partial_latest(tmp_path):
    ck = Checkpointer(CheckpointConfig(str(tmp_path), async_save=False))
    os.makedirs(tmp_path / "step_000099.tmp")
    assert ck.latest_step() is None
    ck.save(5, _tree())
    ck.wait()
    assert ck.latest_step() == 5


def test_retention_gc(tmp_path):
    ck = Checkpointer(CheckpointConfig(str(tmp_path), keep=2, async_save=False))
    for s in (1, 2, 3, 4):
        ck.save(s, _tree())
        ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_000003", "step_000004"]


def test_restore_shape_mismatch_raises(tmp_path):
    save_tree(str(tmp_path), 1, {"w": torch.zeros((4, 4))})
    with pytest.raises(ValueError):
        restore_tree(str(tmp_path), 1, {"w": torch.zeros((8, 4))})


def test_missing_leaf_raises(tmp_path):
    save_tree(str(tmp_path), 1, {"w": torch.zeros(3)})
    with pytest.raises(KeyError):
        restore_tree(str(tmp_path), 1, {"w": torch.zeros(3), "extra_leaf": torch.zeros(2)})


def test_bf16_leaf_refused(tmp_path):
    ck = Checkpointer(CheckpointConfig(str(tmp_path), async_save=False))
    with pytest.raises(TypeError, match="bfloat16"):
        ck.save(1, {"w": torch.zeros((2, 2), dtype=torch.bfloat16)})
    assert ck.latest_step() is None


def test_restore_onto_device(tmp_path):
    """``device=`` places every leaf there whatever the target's device:
    a target of meta tensors (shapes and dtypes only) restores onto the
    CPU."""
    tree = _tree()
    save_tree(str(tmp_path), 1, tree)
    meta = {"params": {k: torch.empty_like(v, device="meta")
                       for k, v in tree["params"].items()},
            "opt": {"step": torch.empty((), dtype=torch.int32, device="meta"),
                    "m": {"w": Q8(torch.empty((16, 8), dtype=torch.int8, device="meta"),
                                  torch.empty((16, 1), device="meta"))}}}
    got, _ = restore_tree(str(tmp_path), 1, meta, device="cpu")
    _assert_trees_equal(got, tree)


class _Position:
    """One position of a (data, model) mesh, without ranks: what
    ``restore(shardings=)`` reads (axis sizes and this rank's
    coordinates)."""

    axis_names = ("data", "model")

    def __init__(self, shape, coords):
        self.shape, self.coords = tuple(shape), dict(zip(self.axis_names, coords))

    def axis_size(self, ax):
        return self.shape[self.axis_names.index(ax)]

    def axis_index(self, ax):
        return self.coords[ax]


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_restore_onto_mesh_shardings(tmp_path, shape):
    """The reference's ``test_elastic_restore_new_shardings``: a whole-leaf
    checkpoint restores onto a mesh, each position holding its shard of
    every leaf (``sharding.train_state_shardings`` of the state) with the
    target's dtype, equal to the saved leaf's slice."""
    from repro_torch.parallel import sharding
    from repro_torch.train.train_step import state_shardings

    cfg = get_smoke("tinyllama-1.1b").with_(dtype=torch.float32)
    tcfg = TrainStepConfig(optimizer=AdamWConfig(moments_dtype="int8"), ef_compression=True)
    tree = init_train_state(torch.Generator().manual_seed(0), cfg, ShardLayout(tp=1), tcfg,
                            device="cpu")
    save_tree(str(tmp_path), 1, tree)
    whole = dict(flatten_with_paths(tree))
    for coords in [(i, j) for i in range(shape[0]) for j in range(shape[1])]:
        mesh = _Position(shape, coords)
        with sharding.use_mesh(mesh, sharding.TRAIN_RULES):
            sh = state_shardings(cfg, ShardLayout(tp=1), tcfg)
            assert flatten_with_paths(sh) == flatten_with_paths(sharding.train_state_shardings(
                init_train_state(None, cfg, ShardLayout(tp=1), tcfg, device="meta")))
            target = init_train_state(None, cfg, ShardLayout(tp=1), tcfg, device="cpu",
                                      shardings=sh)
            got, _ = restore_tree(str(tmp_path), 1, target, shardings=sh)
        by = dict(flatten_with_paths(sh))
        for k, v in flatten_with_paths(got):
            assert v.dtype == whole[k].dtype, k
            assert torch.equal(v, sharding.shard_leaf(whole[k], by[k].spec, mesh)), k
        assert by["params/blocks/0/mixer/wq/w"].sharded


def test_legacy_dotted_keys(tmp_path):
    """Checkpoints whose container fields carry a leading dot ("m/.q")
    restore into today's dotless paths."""
    d = tmp_path / "step_000001"
    d.mkdir()
    np.savez(d / "host_0.npz", **{"m/.q": np.ones((2, 256), np.int8),
                                  "m/.scale": np.full((2, 1), 0.5, np.float32)})
    (d / "MANIFEST.json").write_text('{"step": 1, "extra": {}}')
    got, _ = restore_tree(str(tmp_path), 1, {"m": Q8.quantize(torch.zeros((2, 256)))})
    assert torch.equal(got["m"].dequantize(), torch.full((2, 256), 0.5))


# --------------------------------------------------------- across packages

def _states(moments, ef):
    """The reference's and the port's train states of one smoke config
    (int8 or f32 moments, EF buffers or not): the reference's from its
    init, the port's from its own generator (other values, same tree)."""
    jcfg = jget_smoke("tinyllama-1.1b").with_(dtype=jnp.float32)
    jt = jts.TrainStepConfig(optimizer=jadamw.AdamWConfig(moments_dtype=moments),
                             ef_compression=ef)
    jstate = jts.init_train_state(jax.random.PRNGKey(0), jcfg,
                                  jcommon.ShardLayout(tp=1), jt)
    # moments that are not all zero, so the int8 codes and scales are real
    jstate["opt"]["m"] = jax.tree.map(
        lambda p: jadamw._store(p * 0.5, moments), jstate["params"])
    jstate["opt"]["step"] = jnp.asarray(5, jnp.int32)
    tt = TrainStepConfig(optimizer=AdamWConfig(moments_dtype=moments), ef_compression=ef)
    tstate = init_train_state(torch.Generator().manual_seed(1), get_smoke("tinyllama-1.1b"),
                              ShardLayout(), tt, device="cpu")
    return jstate, tstate


@pytest.mark.parametrize("moments,ef", [("int8", True), ("f32", False)])
def test_reference_checkpoint_restores_into_port(tmp_path, moments, ef):
    jstate, tstate = _states(moments, ef)
    ck = JCheckpointer(JCheckpointConfig(str(tmp_path), async_save=False))
    ck.save(5, jstate, extra={"data_state": {"step": 5, "seed": 0}})
    ck.wait()
    got, extra = Checkpointer(CheckpointConfig(str(tmp_path))).restore(5, tstate)
    assert extra["data_state"] == {"step": 5, "seed": 0}
    want = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    _assert_trees_equal(got, want)


@pytest.mark.parametrize("moments,ef", [("int8", True), ("f32", False)])
def test_port_checkpoint_restores_into_reference(tmp_path, moments, ef):
    jstate, tstate = _states(moments, ef)
    save_tree(str(tmp_path), 3, tstate, extra={"data_state": {"step": 3, "seed": 0}})
    ck = JCheckpointer(JCheckpointConfig(str(tmp_path)))
    assert ck.latest_step() == 3
    got, extra = ck.restore(3, jax.eval_shape(lambda: jstate))
    assert extra["data_state"]["step"] == 3
    want = interop.train_state_to_numpy(tstate)
    got_np = interop.train_state_to_numpy(
        interop.train_state_from_numpy(jax.tree.map(np.asarray, got), device="cpu"))
    a, b = flatten_with_paths(_as_torch(got_np)), flatten_with_paths(_as_torch(want))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def _as_torch(tree):
    return interop.train_state_from_numpy(tree, device="cpu")
