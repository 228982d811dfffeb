"""The paper's own setting: a small low-bit CNN for mobile recognition.

The paper evaluates GeMM kernels standalone over an H x W x D grid chosen
to be "representative for matrix multiplications in small and medium
CNNs" (§IV-B).  This config keeps that use-case alive end to end: a
VGG-ish stack whose conv layers run through im2col + the low-bit GeMM
(core/conv.py), with the standard QNN convention of keeping the first
conv and the classifier in high precision.

``GEMM_GRID`` is the paper's exact measurement grid (Table III), reused
by benchmarks/bench_matmul.py.

The port's own copy of ``repro/configs/paper_cnn.py`` (the port imports
nothing of the JAX package); the two must stay identical.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ConvSpec", "CNNConfig", "PAPER_CNN", "PAPER_CNN_SMOKE",
           "GEMM_GRID"]

# H (im2col rows), W (filters), D (depth) — §IV-B of the paper.
GEMM_GRID = {
    "height": (72, 120, 240, 360),
    "width": (24, 48, 72, 96),
    "depth": (128, 256, 384, 512),
}


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    c_out: int
    kernel: int = 3
    stride: int = 1
    mode: str = "tnn"        # QuantMode value for this layer's GeMM
    pool: bool = False       # 2x2 max-pool after activation


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    img_size: int
    c_in: int
    num_classes: int
    convs: Tuple[ConvSpec, ...]
    accum_bits: int = 16     # paper's 16-bit accumulators; guards eq. (4)/(5)


PAPER_CNN = CNNConfig(
    name="paper-cnn",
    img_size=32,
    c_in=3,
    num_classes=10,
    convs=(
        ConvSpec(32, mode="bf16"),            # first layer stays fp
        ConvSpec(64, mode="tnn", pool=True),
        ConvSpec(128, mode="tnn"),
        ConvSpec(128, mode="tbn", pool=True),
        ConvSpec(256, mode="bnn"),
    ),
)

PAPER_CNN_SMOKE = dataclasses.replace(
    PAPER_CNN, name="paper-cnn-smoke", img_size=8,
    convs=(ConvSpec(8, mode="bf16"), ConvSpec(16, mode="tnn", pool=True),
           ConvSpec(16, mode="bnn")))
