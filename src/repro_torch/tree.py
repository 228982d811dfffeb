"""Parameter trees: the port's stand-in for ``jax.tree``.

The port's trees are nested dicts and lists of tensors, with two
container classes: the optimizer's int8 moment ``Q8`` (children ``q``,
``scale``) and the packed ``QTensor`` (``payload`` — a dict of planes —
``scale``, ``bias``, ``zero``).  The order of leaves and the path strings
are the reference's: a dict's children in sorted key order, as
``jax.tree`` flattens them, a list's by index, a container's by field
name, ``None`` an empty subtree.  So ``global_norm`` sums its leaves in
the reference's order and a checkpoint's keys are the reference's
(``params/blocks/0/attn/wq/w``, ``opt/m/embed/q``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_map", "tree_leaves", "map_with_paths", "flatten_with_paths"]


def _fields(node) -> List[str]:
    """Child field names of a container node (Q8, QTensor), else []."""
    from repro_torch.kernels.qtensor import QTensor
    from repro_torch.optim.adamw import Q8

    if isinstance(node, Q8):
        return ["q", "scale"]
    if isinstance(node, QTensor):
        return ["payload", "scale", "bias", "zero"]
    return []


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree``'s dict/list structure, with the
    nodes of ``rest`` at the same places (a ``Q8`` there is handed over
    whole, as ``flatten_up_to`` hands it in the reference)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """Every leaf of ``tree``'s dict/list structure, in the reference's
    order (containers are leaves here)."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def map_with_paths(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``fn(path, leaf)`` over every tensor leaf, containers opened; the
    tree rebuilt with the results (a container rebuilt with its new
    children).  Paths as the reference's checkpointer writes them."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(tree, dict):
        return {k: map_with_paths(fn, tree[k], join(k)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [map_with_paths(fn, t, join(i)) for i, t in enumerate(tree)]
    if tree is None:
        return None
    fields = _fields(tree)
    if fields:
        new = {f: map_with_paths(fn, getattr(tree, f), join(f)) for f in fields}
        return tree.replace(**new)
    return fn(prefix, tree)


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """[(path, tensor)] of every tensor leaf, containers opened, in the
    reference's order."""
    out: List[Tuple[str, Any]] = []

    def visit(path, leaf):
        out.append((path, leaf))
        return leaf

    map_with_paths(visit, tree)
    return out
