"""Weights across from the JAX package, as numpy arrays only.

The JAX package's ``QTensor`` leaves are uint32 bit planes, int32 affine
grids and zero points, float32 (or bfloat16) matrices and float32
scales; ``np.asarray`` of each gives arrays that load here bit for bit
(``uint32 -> int32`` is a free view, bfloat16 widens exactly to float32
on the way and narrows back).  The port imports nothing of the JAX
package: the caller hands over the arrays and the static fields.

LM parameter trees (:func:`lm_params_from_numpy`) come across whole: the
reference's ``init_lm`` tree (period-stacked leaves) or its
``pack_lm_params`` tree, whose packed projections are stacked containers
(payload planes and scales with a leading period dim), with every leaf
a numpy array — ``jax.tree.map(np.asarray, tree)`` makes one.

Train states (:func:`train_state_from_numpy`, :func:`train_state_to_numpy`)
come across the same way: the reference's ``init_train_state`` or
restored state — ``params``, ``opt`` {``step``, ``m``, ``v``} with its int8
moments as ``Q8`` nodes, ``ef`` — as numpy leaves, and back.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cnn import PaperCNN
from repro_torch.configs.paper_cnn import PAPER_CNN, CNNConfig
from repro_torch.kernels.modes import DEFAULT_DEVICE, QuantMode, resolve_device
from repro_torch.kernels.qtensor import (LAYOUT_AFFINE, LAYOUT_BITPLANE,
                                         LAYOUT_DENSE, QTensor)
from repro_torch.tree import map_with_paths, tree_map

__all__ = ["qtensor_from_numpy", "qtensor_to_numpy", "paper_cnn_from_numpy",
           "lm_params_from_numpy", "train_state_from_numpy", "train_state_to_numpy"]


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _layout(mode: QuantMode) -> str:
    if mode.is_float:
        return LAYOUT_DENSE
    if mode in (QuantMode.INT8, QuantMode.INT4):
        return LAYOUT_AFFINE
    return LAYOUT_BITPLANE


def qtensor_from_numpy(payload: Dict[str, np.ndarray], scale, bias, mode,
                       shape: Tuple[int, int],
                       geometry: Optional[Tuple[int, int, int, int]] = None,
                       device=DEFAULT_DEVICE, zero=None) -> QTensor:
    """A QTensor from the leaves of a JAX-packed one: ``payload`` {key:
    array} (uint32 bit planes, positional planes included when present;
    the int32 grid ``q`` of u8/u4; the matrix ``w`` of f32/bf16),
    ``scale``, ``bias`` and the affine ``zero`` (or None), ``mode``
    (QuantMode or its value), the logical (k, n) ``shape`` and the conv
    ``geometry``.  The layout follows the mode."""
    dev = resolve_device(device)
    mode = QuantMode(mode)
    tensors = {k: _tensor(v, dev) for k, v in payload.items()}
    if mode == QuantMode.BF16:
        tensors["w"] = tensors["w"].to(torch.bfloat16)

    def opt(a):
        return None if a is None else _tensor(a, dev)

    return QTensor(
        payload=tensors, scale=opt(scale), mode=mode,
        shape=(int(shape[0]), int(shape[1])), bias=opt(bias), zero=opt(zero),
        geometry=None if geometry is None else tuple(int(g) for g in geometry),
        layout=_layout(mode))


def qtensor_to_numpy(qt: QTensor) -> Dict[str, object]:
    """The inverse: bit planes as uint32 arrays, the affine grid as int32,
    a float matrix as float32 (bf16 widened exactly), scale, bias and zero
    as arrays, and the static fields — the keyword arguments of
    :func:`qtensor_from_numpy` minus ``device``."""
    def host(t):
        if t is None:
            return None
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    bitplane = qt.layout == LAYOUT_BITPLANE
    return {"payload": {k: host(v).view(np.uint32) if bitplane else host(v)
                        for k, v in qt.payload.items()},
            "scale": host(qt.scale), "bias": host(qt.bias),
            "zero": host(qt.zero), "mode": qt.mode.value, "shape": qt.shape,
            "geometry": qt.geometry}


def paper_cnn_from_numpy(filters: Sequence[np.ndarray], classifier: np.ndarray,
                         cfg: CNNConfig = PAPER_CNN, device=DEFAULT_DEVICE,
                         backend: Optional[str] = None) -> PaperCNN:
    """``PaperCNN`` from the float filters (kh, kw, cin, cout) and the
    (c_last, num_classes) classifier of the JAX example; the low-bit
    filters are packed here, as the example packs them."""
    return PaperCNN(cfg, filters=[np.asarray(f, np.float32) for f in filters],
                    classifier=np.asarray(classifier, np.float32),
                    device=device, backend=backend)


def lm_params_from_numpy(tree, device=DEFAULT_DEVICE):
    """The port's LM parameter tree from the reference's, every leaf a
    numpy array: dicts and lists keep their structure, arrays become
    tensors of the same dtype (bfloat16 stays bfloat16, exactly), and
    every packed container — any object with ``payload``, ``scale``,
    ``mode`` and ``shape`` attributes, as the reference's ``QTensor``
    is — becomes a port :class:`QTensor` holding the same (possibly
    period-stacked) tensors."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return _tensor(a, dev).to(torch.bfloat16)
        return _tensor(a, dev)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        if all(hasattr(node, a) for a in ("payload", "scale", "mode", "shape")):
            def opt(a):
                return None if a is None else np.asarray(a)
            return qtensor_from_numpy(
                {k: np.asarray(v) for k, v in node.payload.items()}, opt(node.scale),
                opt(getattr(node, "bias", None)), getattr(node.mode, "value", node.mode),
                node.shape, geometry=getattr(node, "geometry", None), device=dev,
                zero=opt(getattr(node, "zero", None)))
        return leaf(node)

    return walk(tree)


def _is_q8(node) -> bool:
    return hasattr(node, "q") and hasattr(node, "scale") and not isinstance(node, dict)


def train_state_from_numpy(tree, device=DEFAULT_DEVICE):
    """The port's train state from the reference's, every leaf a numpy
    array: dicts and lists keep their structure, arrays become tensors of
    the same dtype on ``device``, and every int8 moment node — any object
    with ``q`` and ``scale`` attributes, as the reference's ``Q8`` — a
    port :class:`~repro_torch.optim.adamw.Q8`."""
    from repro_torch.optim.adamw import Q8

    dev = resolve_device(device)

    def leaf(node):
        if _is_q8(node):
            return Q8(_tensor(node.q, dev), _tensor(node.scale, dev))
        return _tensor(node, dev)

    return tree_map(leaf, tree)


def train_state_to_numpy(tree):
    """The inverse: every tensor as a numpy array of its dtype, every
    ``Q8`` as a ``Q8`` holding numpy arrays."""
    return map_with_paths(lambda _, t: t.detach().cpu().numpy(), tree)
