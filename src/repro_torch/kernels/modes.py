"""Quantization mode enum, default backend and device — a leaf module so
``repro_torch.core`` and ``repro_torch.kernels`` can both import it.

Backends of the port (the registry key's ``backend``):

* ``"cuda"``  — the hand-written Hopper kernels of ``kernels/csrc``
  (counterpart of the reference's ``"pallas"``);
* ``"torch"`` — their plain PyTorch versions (counterpart of the
  reference's ``"xla"``).
"""

from __future__ import annotations

import enum

import torch

__all__ = ["QuantMode", "DEFAULT_BACKEND", "DEFAULT_DEVICE",
           "accumulator_bound", "resolve_device"]

DEFAULT_BACKEND = "cuda"
DEFAULT_DEVICE = "cuda"


class QuantMode(str, enum.Enum):
    F32 = "f32"
    BF16 = "bf16"
    INT8 = "int8"
    INT4 = "int4"
    TNN = "tnn"    # ternary activations x ternary weights
    TBN = "tbn"    # ternary activations x binary weights
    BNN = "bnn"    # binary  activations x binary weights

    @property
    def is_lowbit(self) -> bool:
        return self in (QuantMode.TNN, QuantMode.TBN, QuantMode.BNN)

    @property
    def is_float(self) -> bool:
        return self in (QuantMode.F32, QuantMode.BF16)


def accumulator_bound(mode: QuantMode):
    """Largest reduction depth k a mode's narrowest accumulator holds
    exactly, or None for the float modes.

    * low-bit — ``|acc| <= 2**24`` keeps every count an exact float32
      integer, which the fused epilogue converts;
    * int8 — u8 x u8 products summed in int32: ``(2**31 - 1) // 255**2``;
    * int4 — u4 x u4 products: ``(2**31 - 1) // 15**2``.
    """
    if mode.is_lowbit:
        return 2**24
    if mode == QuantMode.INT8:
        return (2**31 - 1) // (255 * 255)
    if mode == QuantMode.INT4:
        return (2**31 - 1) // (15 * 15)
    return None


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument.

    A CUDA device without a card raises: the port never moves a run to
    the CPU on its own — the caller asks for ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run the plain PyTorch "
            f"versions on the CPU")
    return dev
