"""Parameter trees: nested dicts of tensors, the port's stand-in for JAX
pytrees.  ``None`` marks a leaf that lives on the other side of a
trainable/frozen partition (as in ``repro.core.adapter_api.partition``)."""
from __future__ import annotations

from typing import Any, Callable, List

Tree = Any


def tree_map(f: Callable, *trees: Tree) -> Tree:
    """``f`` over the leaves of ``trees`` (same structure); a ``None`` leaf
    of the first tree stays ``None``."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in first}
    return f(*trees)


def tree_leaves(tree: Tree) -> List:
    """The non-``None`` leaves, in the order JAX flattens a dict tree
    (sorted keys)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]
