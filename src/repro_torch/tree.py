"""Nested-container helpers in ``jax.tree``'s leaf order.

The training state is nested dicts, tuples and lists of tensors, as in the
reference.  Flattening visits dict keys sorted and tuples and lists in
order, and ``None`` holds no leaf, as ``jax.tree.flatten`` does, so a
checkpoint's ``arr_<i>.npy`` files line up leaf for leaf with the
reference's.  A ``NamedTuple`` is a leaf here (jax flattens its fields):
the compressed gradients of :mod:`repro_torch.distributed.compression`
are the only ones in the port, and they are leaves wherever they appear.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

__all__ = ["TreeDef", "tree_flatten", "tree_unflatten", "tree_leaves", "tree_map"]

_LEAF = "*"


class TreeDef:
    """The structure of a flattened tree: ``_LEAF`` or ``(kind, keys, children)``."""

    def __init__(self, spec):
        self.spec = spec

    def __eq__(self, other):
        return isinstance(other, TreeDef) and self.spec == other.spec

    def __str__(self):
        return f"PyTreeDef({_fmt(self.spec)})"

    __repr__ = __str__


def _fmt(spec) -> str:
    if spec == _LEAF:
        return "*"
    kind, keys, children = spec
    if kind is None:
        return "None"
    if kind is dict:
        return "{" + ", ".join(f"{k!r}: {_fmt(c)}" for k, c in zip(keys, children)) + "}"
    inner = ", ".join(_fmt(c) for c in children)
    if kind is tuple:
        return f"({inner},)" if len(children) == 1 else f"({inner})"
    return f"[{inner}]"


def _walk(node, leaves: list, is_leaf):
    if is_leaf is not None and is_leaf(node):
        leaves.append(node)
        return _LEAF
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return (dict, keys, tuple(_walk(node[k], leaves, is_leaf) for k in keys))
    if type(node) in (tuple, list):
        return (type(node), None, tuple(_walk(c, leaves, is_leaf) for c in node))
    if node is None:
        return (None, None, ())
    leaves.append(node)
    return _LEAF


def _build(spec, it):
    if spec == _LEAF:
        return next(it)
    kind, keys, children = spec
    if kind is None:
        return None
    vals = [_build(c, it) for c in children]
    return dict(zip(keys, vals)) if kind is dict else kind(vals)


# Both walks are module-level functions, not recursive closures: a closure
# that calls itself is a reference cycle, which would hold the leaves (a
# training step's state) until the cyclic garbage collector runs.
def tree_flatten(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None):
    """``(leaves, treedef)``; ``is_leaf`` stops the descent where it is true."""
    leaves = []
    spec = _walk(tree, leaves, is_leaf)
    return leaves, TreeDef(spec)


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of ``treedef`` with ``leaves`` in flattening order."""
    it = iter(leaves)
    out = _build(treedef.spec, it)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``,
    which must have ``tree``'s structure."""
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = []
    for other in rest:
        o_leaves, o_def = tree_flatten(other, is_leaf)
        if o_def != treedef:
            raise ValueError(f"tree structures differ: {treedef} and {o_def}")
        others.append(o_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
