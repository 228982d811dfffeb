"""The port's sharding rules and shard plans against the JAX package's, on
the CPU, without a mesh: both sides resolve against a synthetic context
of axis sizes (the reference's ``tests/test_sharded_qmm.py::_Ctx``).

* ``spec_for``, ``param_spec`` (``param_shardings``) and
  ``payload_plane_axes`` equal the reference's — ``tuple`` of its
  ``PartitionSpec`` — for every ruleset of ``RULESETS``, at axis sizes
  (1, 4), (2, 2), (2, 4), (16, 16) and (2, 16, 16), over every leaf path
  of the ``tnn``-packed smoke trees of all ten configs (the port's own
  packed tree; the reference's traced with ``jax.eval_shape``), the
  optimizer's int8-moment paths included;
* ``psum_accum_dtype``;
* ``shard_plan``, ``shard_plan_conv`` and ``local_dims`` on containers
  both packages packed from the same numpy weights, and ``take_local``'s
  slices reassemble the whole container.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_smoke as jget_smoke
from repro.core.conv import pack_conv_filters as jpack_conv
from repro.kernels._matmul_common import psum_accum_dtype as jpsum_accum_dtype
from repro.kernels.modes import QuantMode as JMode
from repro.kernels.qtensor import QTensor as JQTensor
from repro.models import model as jmodel
from repro.models.common import ShardLayout as JLayout
from repro.models.packing import pack_lm_params as jpack_lm_params
from repro.parallel import qmm_mesh as jqmm_mesh
from repro.parallel import sharding as jsharding
from repro_torch import interop, tree
from repro_torch.configs import get_smoke
from repro_torch.core.conv import pack_conv_filters
from repro_torch.kernels._matmul_common import psum_accum_dtype
from repro_torch.kernels.modes import QuantMode
from repro_torch.models import model as tmodel
from repro_torch.models.common import ShardLayout
from repro_torch.models.packing import pack_lm_params
from repro_torch.parallel import qmm_mesh, sharding

SIZES = [(1, 4), (2, 2), (2, 4), (16, 16), (2, 16, 16)]
RULESETS = sorted(jsharding.RULESETS)
ARCH_NAMES = sorted(ARCHS)


class _Ctx:
    """Synthetic active-mesh stand-in with arbitrary axis sizes (either
    package's rules)."""

    def __init__(self, sizes, rules):
        names = ("pod", "data", "model") if len(sizes) == 3 else ("data", "model")
        self.axis_sizes = dict(zip(names, sizes))
        self.rules = rules
        self.mesh = None


def _ctxs(ruleset, sizes):
    return _Ctx(sizes, jsharding.RULESETS[ruleset]), _Ctx(sizes, sharding.RULESETS[ruleset])


def test_rulesets_equal_reference():
    assert sorted(sharding.RULESETS) == RULESETS
    for name in RULESETS:
        assert sharding.RULESETS[name].table == jsharding.RULESETS[name].table, name


@pytest.mark.parametrize("ruleset", RULESETS)
def test_spec_for_matches_reference(ruleset):
    rng = np.random.default_rng(0)
    logical = [None, "batch", "seq", "embed", "heads", "kv_heads", "head_dim", "ffn",
               "vocab", "expert", "fsdp", "ssm_heads", "conv_dim"]
    for sizes in SIZES:
        jctx, tctx = _ctxs(ruleset, sizes)
        for _ in range(60):
            ndim = int(rng.integers(1, 5))
            shape = tuple(int(rng.choice([1, 2, 3, 4, 8, 12, 16, 32, 64, 96, 256, 512]))
                          for _ in range(ndim))
            axes = tuple(logical[int(i)] for i in rng.integers(0, len(logical), ndim))
            assert sharding.spec_for(shape, axes, tctx) == \
                tuple(jsharding.spec_for(shape, axes, jctx)), (sizes, shape, axes)
    assert sharding.spec_for((4, 8), ("heads", "ffn")) == (None, None)   # no mesh


@pytest.fixture(scope="module")
def packed_trees():
    """arch -> (the reference's packed tree of shapes, flattened with
    paths; the port's packed tree, flattened with paths)."""
    out = {}
    for name in ARCH_NAMES:
        jcfg = jget_smoke(name).with_(quant_policy="tnn")
        shapes = jax.eval_shape(lambda: jpack_lm_params(
            jmodel.init_lm(jax.random.PRNGKey(0), jcfg, JLayout(tp=1)), jcfg))
        ref = {jsharding._path_str(p): (p, leaf)
               for p, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        cfg = get_smoke(name).with_(quant_policy="tnn")
        gen = torch.Generator().manual_seed(0)
        params = tmodel.init_lm(gen, cfg, ShardLayout(tp=1), device="cpu")
        port = pack_lm_params(params, cfg)
        out[name] = (ref, port)
    return out


def _at(node, path):
    """The node of a (spec) tree at a ``tree.map_with_paths`` path."""
    for part in path.split("/"):
        if isinstance(node, dict):
            node = node[part]
        elif isinstance(node, (list, tuple)):
            node = node[int(part)]
        else:
            node = getattr(node, part)
    return node


def _moment_paths(ref):
    """Q8 moment leaves of every float parameter: ``opt/m/<path>/q`` and
    ``/scale`` keep the parameter's rank (the scale's last dim 1)."""
    out = []
    for path, (_, leaf) in ref.items():
        if "payload" in path or len(leaf.shape) < 2:
            continue
        out.append((f"opt/m/{path}/q", tuple(leaf.shape)))
        out.append((f"opt/m/{path}/scale", tuple(leaf.shape[:-1]) + (1,)))
    return out


@pytest.mark.parametrize("ruleset", RULESETS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_spec_matches_reference(packed_trees, arch, ruleset):
    ref, port = packed_trees[arch]
    flat = dict(tree.flatten_with_paths(port))
    assert sorted(flat) == sorted(ref)
    for sizes in SIZES:
        jctx, tctx = _ctxs(ruleset, sizes)
        specs = sharding.param_shardings(port, tctx)
        for path, (jpath, leaf) in ref.items():
            want = tuple(jsharding.param_spec(jpath, leaf, jctx))
            assert tuple(flat[path].shape) == tuple(leaf.shape), path
            assert sharding.param_spec(path, flat[path], tctx) == want, (sizes, path)
            assert _at(specs, path) == want, (sizes, path)
        for path, shape in _moment_paths(ref):
            leaf = jax.ShapeDtypeStruct(shape, jnp.int8)
            jpath = tuple(jax.tree_util.DictKey(p) for p in path.split("/"))
            assert sharding.param_spec(path, torch.empty(shape, dtype=torch.int8), tctx) == \
                tuple(jsharding.param_spec(jpath, leaf, jctx)), (sizes, path)


@pytest.mark.parametrize("ruleset", RULESETS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_payload_plane_axes_match_reference(packed_trees, arch, ruleset):
    ref, port = packed_trees[arch]
    flat = dict(tree.flatten_with_paths(port))
    planes = [p for p in ref if "/payload/" in p]
    assert planes or arch not in ("tinyllama-1.1b",)
    for sizes in SIZES:
        jctx, tctx = _ctxs(ruleset, sizes)
        for path in planes:
            want = jsharding.payload_plane_axes(path, ref[path][1], jctx)
            assert sharding.payload_plane_axes(path, flat[path], tctx) == want, (sizes, path)
    assert sharding.payload_plane_axes(planes[0], flat[planes[0]]) is None   # no mesh


def test_psum_accum_dtype_matches_reference():
    for k in (32, 256, 2 ** 14 - 32, 2 ** 14, 2 ** 14 + 32, 5632, 1 << 20):
        assert str(psum_accum_dtype(k)).replace("torch.", "") == jpsum_accum_dtype(k).name, k


def _both_packed(mode, w, bias=None):
    jqt = JQTensor.from_dense(jnp.asarray(w), JMode(mode),
                              bias=None if bias is None else jnp.asarray(bias))
    qt = interop.qtensor_from_numpy({k: np.asarray(v) for k, v in jqt.payload.items()},
                                    np.asarray(jqt.scale), bias, mode, jqt.shape, device="cpu")
    return jqt, qt


PSPECS = [("model", "data"), ("model", None), (None, "model"), ("data", "model"),
          ("tp", "ep"), (None, None)]


@pytest.mark.parametrize("mode", ["tnn", "tbn", "bnn"])
def test_shard_plan_and_local_dims_match_reference(mode):
    rng = np.random.default_rng(3)
    for k, n in ((256, 64), (250, 48), (2048, 256), (96, 40)):
        w = rng.standard_normal((k, n)).astype(np.float32)
        jqt, qt = _both_packed(mode, w)
        for sizes in SIZES + [(2, 5), (1, 1), (4, 2)]:
            jctx, tctx = _ctxs("serve_lowbit", sizes)
            assert qmm_mesh.shard_plan(qt, tctx) is None          # never annotated
            for pspec in PSPECS:
                jp = jqmm_mesh.shard_plan(jqt.replace(pspec=pspec), jctx)
                tp = qmm_mesh.shard_plan(qt.replace(pspec=pspec), tctx)
                assert (tp is None) == (jp is None), (k, n, sizes, pspec)
                if tp is not None:
                    assert dataclass_fields(tp) == dataclass_fields(jp), (k, n, sizes, pspec)
                assert qmm_mesh.local_dims(qt.replace(pspec=pspec), tctx) == \
                    jqmm_mesh.local_dims(jqt.replace(pspec=pspec), jctx)


def dataclass_fields(plan):
    return (plan.n_axis, plan.k_axis, plan.n_shards, plan.k_shards, plan.acc_dtype)


@pytest.mark.parametrize("mode", ["tnn", "tbn", "bnn"])
def test_shard_plan_conv_matches_reference(mode):
    rng = np.random.default_rng(4)
    for geom in ((3, 3, 5, 16), (3, 3, 32, 64), (1, 1, 40, 12)):
        f = rng.standard_normal(geom).astype(np.float32)
        jqt = jpack_conv(jnp.asarray(f), JMode(mode))
        qt = pack_conv_filters(torch.from_numpy(f), QuantMode(mode))
        for sizes in SIZES + [(2, 5)]:
            jctx, tctx = _ctxs("serve_lowbit", sizes)
            for pspec in PSPECS:
                jp = jqmm_mesh.shard_plan_conv(jqt.replace(pspec=pspec), jctx)
                tp = qmm_mesh.shard_plan_conv(qt.replace(pspec=pspec), tctx)
                assert (tp is None) == (jp is None), (geom, sizes, pspec)
                if tp is not None:
                    assert dataclass_fields(tp) == dataclass_fields(jp)


class _Grid:
    """A mesh stand-in: the coordinates of one position of the grid."""

    def __init__(self, coords):
        self.coords = coords

    def axis_index(self, axis):
        return self.coords[axis]


@pytest.mark.parametrize("mode", ["tnn", "bnn"])
def test_take_local_slices_reassemble(mode):
    rng = np.random.default_rng(5)
    w = rng.standard_normal((250, 64)).astype(np.float32)
    b = rng.standard_normal((64,)).astype(np.float32)
    _, qt = _both_packed(mode, w, b)
    qt = qt.replace(pspec=("model", "data"))
    _, tctx = _ctxs("serve_lowbit", (2, 4))
    key = "plus" if mode == "tnn" else "bits"
    rows = []
    for mi in range(4):
        cols = []
        for di in range(2):
            tctx.mesh = _Grid({"data": di, "model": mi})
            loc = qmm_mesh.take_local(qt, tctx)
            assert loc.pspec == qt.pspec and loc.shape == qt.shape
            assert tuple(loc.payload[key].shape) == (16, 4)
            assert torch.equal(loc.scale, qt.scale[mi * 16:(mi + 1) * 16])
            assert torch.equal(loc.bias, qt.bias[mi * 16:(mi + 1) * 16])
            cols.append(loc.payload[key])
        rows.append(torch.cat(cols, dim=1))
    assert torch.equal(torch.cat(rows, dim=0), qt.payload[key])
    with pytest.raises(ValueError, match="slice"):
        qmm_mesh.check_whole(loc)
