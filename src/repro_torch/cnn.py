"""The paper's low-bit CNN as an ``nn.Module`` (``PaperCNN``).

The forward of ``examples/lowbit_cnn_inference.py`` step by step: the
first conv in float32 (im2col + a float32 product, the standard QNN
practice), every other conv a packed low-bit conv through the
implicit-im2col kernel (``core.conv.conv2d_packed``), ReLU after each,
2x2 max-pool where the config says ``pool``, then the mean over the
spatial axes and the float classifier.  Filters are packed once, at
construction.  Activations are NHWC float32, filters (kh, kw, cin, cout).

Weights are random, from a numpy seed (:func:`paper_cnn_weights`), with
the example's scaling; ``interop.paper_cnn_from_numpy`` builds the module
from given weights.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch import obs
from repro_torch.configs.paper_cnn import PAPER_CNN, CNNConfig
from repro_torch.core.conv import (check_conv_depth, conv2d_packed,
                                   conv2d_quantized, matmul_f32,
                                   pack_conv_filters)
from repro_torch.core.quantize import f32_scalar
from repro_torch.kernels.modes import (DEFAULT_BACKEND, DEFAULT_DEVICE,
                                       QuantMode, resolve_device)

__all__ = ["PaperCNN", "LowBitConv2d", "FloatConv2d", "paper_cnn_weights"]


def paper_cnn_weights(cfg: CNNConfig = PAPER_CNN, seed: int = 0):
    """Random float32 weights for ``cfg`` from a numpy seed: per-layer
    filters (kh, kw, cin, cout) scaled by (kh*kw*cin)**-0.5 and the
    (c_last, num_classes) classifier scaled by c_last**-0.5, as the
    example scales them."""
    rng = np.random.default_rng(seed)
    filters, c_in = [], cfg.c_in
    for spec in cfg.convs:
        k = spec.kernel
        w = rng.standard_normal((k, k, c_in, spec.c_out), dtype=np.float32)
        filters.append(w * np.float32((k * k * c_in) ** -0.5))
        c_in = spec.c_out
    cls = rng.standard_normal((c_in, cfg.num_classes), dtype=np.float32)
    return filters, cls * np.float32(c_in ** -0.5)


class LowBitConv2d(nn.Module):
    """A packed TNN/TBN/BNN conv: the filters' QTensor, packed once."""

    def __init__(self, filters: torch.Tensor, mode: QuantMode, stride: int,
                 backend: str):
        super().__init__()
        self.packed = pack_conv_filters(filters, mode)
        self.stride = stride
        self.backend = backend

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_packed(x, self.packed, stride=self.stride,
                             backend=self.backend)


class FloatConv2d(nn.Module):
    """The float first conv: im2col + a float32 product."""

    def __init__(self, filters: torch.Tensor, mode: QuantMode, stride: int):
        super().__init__()
        self.register_buffer("filters", filters)
        self.mode = mode
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_quantized(x, self.filters, mode=self.mode,
                                stride=self.stride)


class PaperCNN(nn.Module):
    """``cfg``'s conv stack + mean-pool + classifier, on ``device``.

    ``filters`` / ``classifier`` are float32 arrays or tensors in the
    layouts of :func:`paper_cnn_weights` (which makes them from ``seed``
    when omitted).  ``backend`` picks the low-bit convs' kernels: "cuda"
    (the default) or "torch" (their plain versions).  Each low-bit layer
    is checked against the eq. (5) depth bound of ``cfg.accum_bits``.
    """

    def __init__(self, cfg: CNNConfig = PAPER_CNN, *,
                 filters: Optional[Sequence] = None, classifier=None,
                 seed: int = 0, device=DEFAULT_DEVICE,
                 backend: Optional[str] = None):
        super().__init__()
        dev = resolve_device(device)
        if filters is None:
            filters, classifier = paper_cnn_weights(cfg, seed)
        if len(filters) != len(cfg.convs) or classifier is None:
            raise ValueError(f"{cfg.name} needs {len(cfg.convs)} filters and "
                             f"a classifier")
        self.cfg = cfg
        self.backend = backend or DEFAULT_BACKEND
        layers: List[nn.Module] = []
        c_in = cfg.c_in
        for spec, w in zip(cfg.convs, filters):
            w = torch.as_tensor(w, dtype=torch.float32).to(dev)
            k = spec.kernel
            if tuple(w.shape) != (k, k, c_in, spec.c_out):
                raise ValueError(f"filter shape {tuple(w.shape)} does not "
                                 f"match {spec} with c_in={c_in}")
            mode = QuantMode(spec.mode)
            if mode.is_lowbit:
                check_conv_depth(c_in, k, k, accum_bits=cfg.accum_bits)
                layers.append(LowBitConv2d(w, mode, spec.stride, self.backend))
            else:
                layers.append(FloatConv2d(w, mode, spec.stride))
            c_in = spec.c_out
        self.layers = nn.ModuleList(layers)
        self.register_buffer(
            "classifier", torch.as_tensor(classifier, dtype=torch.float32).to(dev))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, c_in) images -> the last conv's feature map, after
        its ReLU (and pool)."""
        h = x.to(torch.float32)
        for spec, layer in zip(self.cfg.convs, self.layers):
            h = torch.relu(layer(h))
            if spec.pool:
                b, hh, ww, c = h.shape
                h = h.reshape(b, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, c_in) float images -> (B, num_classes) logits."""
        with obs.annotate("repro_torch.cnn.forward"):
            h = self.features(x)
            pooled = h.sum(dim=(1, 2)) / f32_scalar(h.shape[1] * h.shape[2], h)
            return matmul_f32(pooled, self.classifier)
