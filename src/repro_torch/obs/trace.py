"""Profiler trace-annotation hook.

``annotate("prefill_chunk")`` wraps a host-side region in
``torch.profiler.record_function`` so a ``torch.profiler`` trace shows
the engine's regions beside the kernels they launched.  When obs is
disabled it is a null context, so the serving loop never pays for it.

Counterpart of ``repro/obs/trace.py``, whose ``jax.profiler
.TraceAnnotation`` this replaces.
"""

from __future__ import annotations

import contextlib

import torch

from .registry import obs_enabled

__all__ = ["annotate"]


def annotate(name: str):
    """Context manager naming a host region in torch.profiler traces."""
    if not obs_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)
