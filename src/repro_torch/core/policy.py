"""Per-layer quantization policy.

Counterpart of ``repro/core/policy.py``.  ``QuantPolicy`` maps projection
*classes* (attention, FFN, SSM, head) to a :class:`QuantMode` and a
kernel backend, so one flag turns an LM architecture into its
TNN/TBN/BNN (or u8/u4, or float) variant; embeddings, norms and the LM
head's float product stay in high precision.

Backends map onto the port's registry: the reference's default ``"xla"``
becomes ``"cuda"`` (the Hopper kernels; their plain versions only on CPU
tensors), never the plain ``"torch"``; ``"dense"`` stays ``"dense"`` (the
tensor-core kernels).  The ``"indexed"`` backend is not ported yet: the
policies that name it (``tnn_indexed``, ``bnn_indexed``, ``tnn_mixed``)
raise ``KeyError`` in :meth:`QuantPolicy.validate` and at their first
projection, as the reference does for a missing registry cell.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.kernels.modes import QuantMode

__all__ = ["QuantPolicy", "POLICIES"]

_BACKEND_FIELD = {
    "attn_proj": "attn_backend",
    "ffn_proj": "ffn_backend",
    "ssm_proj": "ssm_backend",
    "head": "head_backend",
}


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    name: str
    attn_proj: QuantMode = QuantMode.BF16   # Q/K/V/O projections
    ffn_proj: QuantMode = QuantMode.BF16    # FFN up, gate, down
    ssm_proj: QuantMode = QuantMode.BF16    # Mamba in/out projections
    head: QuantMode = QuantMode.BF16        # LM head (kept float)
    backend: str = "cuda"                   # global default backend
    # Per-class overrides: None falls through to the global ``backend``.
    attn_backend: Optional[str] = None
    ffn_backend: Optional[str] = None
    ssm_backend: Optional[str] = None
    head_backend: Optional[str] = None

    def for_class(self, cls: str) -> QuantMode:
        return getattr(self, cls)

    def backend_for(self, cls: str) -> str:
        """Backend of a projection class: the per-class override when set,
        else the policy-wide default."""
        override = getattr(self, _BACKEND_FIELD[cls])
        return override if override is not None else self.backend

    def with_backend(self, backend: str) -> "QuantPolicy":
        """The same policy with every class on ``backend`` (e.g. "torch",
        the plain versions, to hold a run against its kernels)."""
        return dataclasses.replace(self, backend=backend, **{
            f: None for f in _BACKEND_FIELD.values()})

    def validate(self) -> "QuantPolicy":
        """Check every low-bit (mode, backend) assignment against the
        kernel registry's fused GeMM cells; raises KeyError naming the
        missing cell.  Float classes never dispatch through the registry
        and affine classes fall back to the default backend's cell (as
        ``ops.qmm`` does).  Returns self."""
        import repro_torch.kernels.ops  # noqa: F401  (registers the cells)
        from repro_torch.kernels import registry

        for cls in _BACKEND_FIELD:
            mode = self.for_class(cls)
            if mode.is_lowbit:
                registry.lookup(mode, self.backend_for(cls), fused=True)
        return self


def _uniform(name: str, mode: QuantMode, head: QuantMode = QuantMode.BF16,
             backend: str = "cuda", **backend_overrides) -> QuantPolicy:
    return QuantPolicy(name=name, attn_proj=mode, ffn_proj=mode,
                       ssm_proj=mode, head=head, backend=backend,
                       **backend_overrides)


POLICIES = {
    "bf16": _uniform("bf16", QuantMode.BF16),
    "f32": _uniform("f32", QuantMode.F32),
    "int8": _uniform("int8", QuantMode.INT8),
    "int4": _uniform("int4", QuantMode.INT4),
    "tnn": _uniform("tnn", QuantMode.TNN),
    "tbn": _uniform("tbn", QuantMode.TBN),
    "bnn": _uniform("bnn", QuantMode.BNN),
    # packed storage, tensor-core compute
    "tnn_dense": _uniform("tnn_dense", QuantMode.TNN, backend="dense"),
    "bnn_dense": _uniform("bnn_dense", QuantMode.BNN, backend="dense"),
    # the indexed-redundancy backend (not ported yet: KeyError)
    "tnn_indexed": _uniform("tnn_indexed", QuantMode.TNN, backend="indexed"),
    "bnn_indexed": _uniform("bnn_indexed", QuantMode.BNN, backend="indexed"),
    # mixed per-class backends: FFN on the indexed gather, attention popcount
    "tnn_mixed": _uniform("tnn_mixed", QuantMode.TNN, ffn_backend="indexed"),
}
