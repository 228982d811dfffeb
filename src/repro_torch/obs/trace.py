"""Profiler trace-annotation hook.

``annotate("prefill_chunk")`` wraps a host-side region in
``torch.profiler.record_function`` so a ``torch.profiler`` trace shows
the program's regions beside the kernels they launched.  It enters a
``record_function`` only while obs is on and a profiler session is
recording; otherwise it is one shared null context, so code that runs
with no profiler open pays a flag check per region.

The port's span names are listed in the package docstring.

Counterpart of ``repro/obs/trace.py``, whose ``jax.profiler
.TraceAnnotation`` this replaces.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

from .registry import obs_enabled

__all__ = ["annotate"]

_NULL = contextlib.nullcontext()


def annotate(name: str):
    """Context manager naming a host region in torch.profiler traces; a
    shared null context when obs is off or no profiler session is
    recording."""
    if not (_profiler._is_profiler_enabled and obs_enabled()):
        return _NULL
    return torch.profiler.record_function(name)
