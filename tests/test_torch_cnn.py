"""The port's paper CNN end to end against the JAX example's loop, and the
port's boundaries.

* ``PAPER_CNN_SMOKE`` built through ``interop.paper_cnn_from_numpy`` on the
  CPU against ``examples/lowbit_cnn_inference.py``'s loop (written out
  here with the JAX package's functions) at the same weights: logits to
  rtol/atol 1e-5 — each side derives its own per-layer statistics
  (float32 sums in another order) and runs its own float first layer
  and classifier, which differ by ULPs;
* the exact variant: JAX-packed filters loaded through
  ``qtensor_from_numpy`` and the JAX per-layer statistics injected
  through ``qconv(act_stats=)``: every low-bit layer's feature map
  ``array_equal``, the float first layer to 1e-5;
* no file of the port, nor ``chip_smoke.py``, imports ``jax`` or
  ``repro``; entry points — ``PaperCNN``, the interop loaders,
  ``python -m repro_torch.launch.serve`` and ``python -m
  repro_torch.tune`` — default to the card and raise without one;
  ``chip_smoke.py`` fails without a card.
"""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_cnn as jcfg
from repro.core import conv as jconv
from repro.kernels import conv_fused as jcf
from repro.kernels.modes import QuantMode as JMode
from repro_torch import interop
from repro_torch.cnn import PaperCNN, paper_cnn_weights
from repro_torch.configs import paper_cnn as tcfg
from repro_torch.core import conv as tconv
from repro_torch.kernels import ops
from repro_torch.kernels.modes import QuantMode
from repro_torch.launch.serve import main as serve_main
from repro_torch.tune.__main__ import main as tune_main

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = tcfg.PAPER_CNN_SMOKE
TOL = 1e-5


def _pool(h):
    b, hh, ww, c = h.shape
    return h.reshape(b, hh // 2, 2, ww // 2, 2, c).max(axis=(2, 4))


def _jax_example(x, filters, classifier, cfg):
    """examples/lowbit_cnn_inference.py's deployment loop at the given
    weights; returns (per-layer maps, per-layer stats, packed filters,
    logits), all numpy."""
    h = jnp.asarray(x)
    maps, stats, packed = [], [], []
    for spec, w in zip(cfg.convs, filters):
        mode = JMode(spec.mode)
        if mode.is_lowbit:
            qt = jconv.pack_conv_filters(jnp.asarray(w), mode)
            st = jcf.conv_act_stats(h, mode, spec.kernel, spec.kernel, spec.stride,
                                    "SAME")
            h = jconv.conv2d_packed(h, qt, stride=spec.stride)
            packed.append(qt)
            stats.append({k: np.asarray(v) for k, v in st.items()})
        else:
            h = jconv.conv2d_quantized(h, jnp.asarray(w), mode=mode, stride=spec.stride)
            packed.append(None)
            stats.append(None)
        h = jax.nn.relu(h)
        if spec.pool:
            h = _pool(h)
        maps.append(np.asarray(h))
    logits = np.asarray(h.mean(axis=(1, 2)) @ jnp.asarray(classifier))
    return maps, stats, packed, logits


def _inputs(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, CFG.img_size, CFG.img_size, CFG.c_in))
    return x.astype(np.float32)


def test_config_copy_matches_reference():
    for name in ("PAPER_CNN", "PAPER_CNN_SMOKE"):
        ref, got = getattr(jcfg, name), getattr(tcfg, name)
        assert (got.name, got.img_size, got.c_in, got.num_classes, got.accum_bits) == \
            (ref.name, ref.img_size, ref.c_in, ref.num_classes, ref.accum_bits)
        assert [vars(s) for s in got.convs] == [vars(s) for s in ref.convs]
    assert tcfg.GEMM_GRID == jcfg.GEMM_GRID


def test_paper_cnn_smoke_matches_jax_example():
    filters, classifier = paper_cnn_weights(CFG, seed=1)
    x = _inputs()
    _, _, _, ref = _jax_example(x, filters, classifier, CFG)
    model = interop.paper_cnn_from_numpy(filters, classifier, CFG, device="cpu")
    got = model(torch.from_numpy(x))
    assert got.shape == (2, CFG.num_classes) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_paper_cnn_smoke_exact_with_jax_weights_and_stats():
    filters, classifier = paper_cnn_weights(CFG, seed=2)
    x = _inputs(seed=3, batch=3)
    maps, stats, packed, _ = _jax_example(x, filters, classifier, CFG)
    h = torch.from_numpy(x)
    for i, (spec, w) in enumerate(zip(CFG.convs, filters)):
        mode = QuantMode(spec.mode)
        if mode.is_lowbit:
            jqt = packed[i]
            qt = interop.qtensor_from_numpy(
                {k: np.asarray(v) for k, v in jqt.payload.items()},
                np.asarray(jqt.scale), None, spec.mode, jqt.shape, jqt.geometry,
                device="cpu")
            h = ops.qconv(h, qt, stride=spec.stride, act_stats=stats[i])
        else:
            h = tconv.conv2d_quantized(h, torch.from_numpy(w), mode=mode,
                                       stride=spec.stride)
        h = torch.relu(h)
        if spec.pool:
            b, hh, ww, c = h.shape
            h = h.reshape(b, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))
        if mode.is_lowbit:
            np.testing.assert_array_equal(h.numpy(), maps[i])
        else:
            np.testing.assert_allclose(h.numpy(), maps[i], rtol=TOL, atol=TOL)


def test_paper_cnn_backends_agree_on_cpu():
    model = PaperCNN(CFG, seed=4, device="cpu")
    plain = PaperCNN(CFG, seed=4, device="cpu", backend="torch")
    x = torch.from_numpy(_inputs(seed=5))
    assert torch.equal(model.features(x), plain.features(x))
    assert torch.equal(model(x), plain(x))


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [(f.name, mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_entry_points_default_to_the_card(tmp_path):
    filters, classifier = paper_cnn_weights(CFG, seed=0)
    planes = {"bits": np.zeros((4, 1), np.uint32)}
    calls = [lambda: PaperCNN(CFG),
             lambda: interop.paper_cnn_from_numpy(filters, classifier, CFG),
             lambda: interop.qtensor_from_numpy(planes, np.ones(4, np.float32), None,
                                                "bnn", (20, 4)),
             lambda: serve_main(["--smoke", "--requests", "1", "--new-tokens", "1"]),
             lambda: tune_main(["--shapes", "8x8x32", "--modes", "tnn", "--backends",
                                "cuda", "--reps", "1", "--warmup", "1",
                                "--cache", str(tmp_path / "plans.json")])]
    for call in calls:
        if torch.cuda.is_available():
            assert call() is not None
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_chip_smoke_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr
