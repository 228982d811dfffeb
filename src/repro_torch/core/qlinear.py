"""QuantLinear — the projection primitive of the port's models.

Counterpart of ``repro/core/qlinear.py``.  Two regimes, as low-bit
networks are deployed:

* **QAT / training**: parameters are float master weights; ``apply``
  quantizes weights *and* activations on the fly and runs the low-bit
  pipeline with straight-through gradients (``ops.quantized_matmul``,
  a ``torch.autograd.Function``).
* **Packed inference**: ``pack()`` converts the master weights into a
  :class:`~repro_torch.kernels.qtensor.QTensor` once, offline (the
  paper's Algorithm 2 PackedB, bias inside); ``apply_packed`` is one
  ``ops.qmm`` call — activation quantization, the popcount (or affine,
  or float) core and the eq. (2) epilogue.

The overflow guard of eq. (4) is enforced here: in int16-fidelity mode a
reduction deeper than k_max is a configuration error.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core import quantize
from repro_torch.core.conv import matmul_f32
from repro_torch.kernels import ops
from repro_torch.kernels.modes import (DEFAULT_BACKEND, DEFAULT_DEVICE,
                                       QuantMode, resolve_device)
from repro_torch.kernels.qtensor import QTensor
from repro_torch.parallel import sharding

__all__ = ["QuantLinear", "linear_init", "linear_apply"]


@dataclasses.dataclass(frozen=True)
class QuantLinear:
    d_in: int
    d_out: int
    mode: QuantMode = QuantMode.BF16
    use_bias: bool = False
    backend: str = DEFAULT_BACKEND
    # int16-fidelity accumulation (the paper's register width): a
    # validation mode only; the kernels accumulate in int32.
    paper_accum_i16: bool = False

    def __post_init__(self):
        if self.paper_accum_i16 and self.mode.is_lowbit:
            kmax = quantize.k_max(1, 16, signed_unit=True)
            if self.d_in > kmax:
                raise ValueError(
                    f"d_in={self.d_in} exceeds k_max={kmax} for 16-bit "
                    f"accumulation (paper eq. (4)); shrink the layer or "
                    f"use int32 accumulation")

    # -- parameters ---------------------------------------------------------

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=DEFAULT_DEVICE) -> Dict[str, Any]:
        """Glorot-normal master weights ``{"w": (d_in, d_out)}`` (and a
        zero ``"b"``) on ``device``, drawn from ``generator`` (which must
        live there)."""
        dev = resolve_device(device)
        std = (2.0 / (self.d_in + self.d_out)) ** 0.5
        w = torch.randn((self.d_in, self.d_out), generator=generator, device=dev) * std
        p = {"w": w.to(dtype)}
        if self.use_bias:
            p["b"] = torch.zeros((self.d_out,), dtype=dtype, device=dev)
        return p

    # -- QAT / training forward --------------------------------------------

    def apply(self, params: Dict[str, Any], x: torch.Tensor,
              role: Optional[str] = None,
              stats: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """The QAT forward.  ``role`` is the projection's place on a
        tensor-parallel training split (the model reads it off the leaf's
        spec, ``sharding.tp_split``): "col" when ``params["w"]`` is this
        rank's n slice, "row" when it is its k slice and ``x`` its slice of
        the input features, whose partial sums are then reduced over the
        tensor-parallel axis into the rows this rank keeps (its sequence
        shard under sequence parallelism: the output has ``x``'s leading
        dims with the last one, the sequence, cut by the axis' size).
        None: the whole matrix.  ``stats`` ({"act", "w"}, either optional)
        replaces the statistics ``ops.quantized_matmul`` would derive."""
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        w = params["w"]
        if self.mode in (QuantMode.BF16, QuantMode.F32):
            y = matmul_f32(x2.to(torch.bfloat16), w.to(torch.bfloat16)) \
                if self.mode == QuantMode.BF16 else matmul_f32(x2, w)
            if role == "row":
                y = sharding.tp_reduce(y.reshape(*lead, self.d_out), dim=len(lead) - 1)
        else:
            y = ops.quantized_matmul(x2, w.to(torch.float32), self.mode, self.backend,
                                     role=role, lead=lead, stats=stats)
        if self.use_bias:
            y = y + params["b"]
        out = lead if role != "row" else (*lead[:-1], -1)
        return y.reshape(*out, self.d_out).to(x.dtype)

    # -- packed inference ----------------------------------------------------

    def pack(self, params: Dict[str, Any]) -> QTensor:
        """Master weights -> QTensor (Algorithm 2; the bias travels inside)."""
        return QTensor.from_dense(params["w"].to(torch.float32), self.mode,
                                  bias=params["b"] if self.use_bias else None)

    def apply_packed(self, packed: QTensor, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        y = ops.qmm(x2.to(torch.float32), packed, backend=self.backend)
        return y.reshape(*lead, self.d_out).to(x.dtype)


# Functional forms ---------------------------------------------------------

def linear_init(generator: torch.Generator, d_in: int, d_out: int,
                dtype=torch.float32, device=DEFAULT_DEVICE) -> Dict[str, Any]:
    return QuantLinear(d_in, d_out).init(generator, dtype, device)


def linear_apply(params: Dict[str, Any], x: torch.Tensor,
                 mode: QuantMode = QuantMode.BF16,
                 backend: str = DEFAULT_BACKEND, role: Optional[str] = None,
                 stats: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """:meth:`QuantLinear.apply` of the layer ``params`` describes (its
    shapes are this rank's slice's on a tensor-parallel split, ``role``)."""
    d_in, d_out = params["w"].shape
    layer = QuantLinear(d_in, d_out, mode=mode, use_bias="b" in params,
                        backend=backend)
    return layer.apply(params, x, role, stats)
