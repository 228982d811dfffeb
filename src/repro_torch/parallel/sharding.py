"""Logical-axis sharding hooks, single device.

Counterpart of ``repro/parallel/sharding.py``, whose rule tables resolve
logical axes ("batch", "heads", "ffn", ...) onto a device mesh.  The port
runs on one card until the mesh slice lands, so the hooks the model
modules call are stand-ins: :func:`active` is None, :func:`constrain` is
the identity, :func:`param_shardings` and :func:`payload_plane_axes`
return None, and :func:`use_mesh` accepts only "no mesh".
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

__all__ = ["use_mesh", "active", "constrain", "param_shardings",
           "payload_plane_axes"]


@contextlib.contextmanager
def use_mesh(mesh=None, rules=None):
    """No mesh: a no-op context.  A real mesh raises (not ported yet)."""
    if mesh is not None:
        raise NotImplementedError("device meshes are not ported yet (the "
                                  "sharding slice of ROADMAP.md queue 1)")
    yield


def active():
    """The active mesh context: always None on one device."""
    return None


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Sharding constraint by logical axes: the identity on one device."""
    return x


def param_shardings(params, ctx=None):
    """Per-leaf placements: None (everything lives on the one card)."""
    return None


def payload_plane_axes(path: str, plane, ctx=None):
    """Mesh axes of a packed payload plane: None without a mesh."""
    return None
