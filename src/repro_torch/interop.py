"""Weights across from the JAX package, as numpy arrays only.

The JAX package's ``QTensor`` leaves are uint32 bit planes and float32
scales; ``np.asarray`` of each gives arrays that load here bit for bit
(``uint32 -> int32`` is a free view).  The port imports nothing of the
JAX package: the caller hands over the arrays and the static fields.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cnn import PaperCNN
from repro_torch.configs.paper_cnn import PAPER_CNN, CNNConfig
from repro_torch.kernels.modes import DEFAULT_DEVICE, QuantMode, resolve_device
from repro_torch.kernels.qtensor import LAYOUT_BITPLANE, QTensor

__all__ = ["qtensor_from_numpy", "qtensor_to_numpy", "paper_cnn_from_numpy"]


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def qtensor_from_numpy(payload: Dict[str, np.ndarray], scale, bias, mode,
                       shape: Tuple[int, int],
                       geometry: Optional[Tuple[int, int, int, int]] = None,
                       device=DEFAULT_DEVICE) -> QTensor:
    """A bit-plane QTensor from the leaves of a JAX-packed one: ``payload``
    {key: uint32 array} (positional planes included when present),
    ``scale`` and ``bias`` (or None) float arrays, ``mode`` (QuantMode or
    its value), the logical (k, n) ``shape`` and the conv ``geometry``."""
    dev = resolve_device(device)
    return QTensor(
        payload={k: _tensor(v, dev) for k, v in payload.items()},
        scale=None if scale is None else _tensor(scale, dev),
        mode=QuantMode(mode), shape=(int(shape[0]), int(shape[1])),
        bias=None if bias is None else _tensor(bias, dev),
        geometry=None if geometry is None else tuple(int(g) for g in geometry),
        layout=LAYOUT_BITPLANE)


def qtensor_to_numpy(qt: QTensor) -> Dict[str, object]:
    """The inverse: the payload as uint32 arrays, scale and bias as float
    arrays, and the static fields — the keyword arguments of
    :func:`qtensor_from_numpy` minus ``device``."""
    def host(t):
        return None if t is None else t.detach().cpu().numpy()
    return {"payload": {k: host(v).view(np.uint32)
                        for k, v in qt.payload.items()},
            "scale": host(qt.scale), "bias": host(qt.bias),
            "mode": qt.mode.value, "shape": qt.shape,
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
