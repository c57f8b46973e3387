"""Nested dicts and lists of tensors: the port's parameter trees.

The reference maps over pytrees with ``jax.tree``; the port's trees are
plain nested dicts (and, for the paper models, a ``"blocks"`` list), so
three small functions do: :func:`flatten` to a list of leaves and a
structure, :func:`unflatten` back, and :func:`tree_map` over trees of
one structure.  Leaves are taken in insertion order.  ``is_leaf`` stops
the walk at a subtree (an optimizer moment ``{"q", "scale"}``); ``None``
is kept as structure, not a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

_LEAF = object()


def flatten(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
            ) -> Tuple[List[Any], Any]:
    """``tree`` -> (leaves, structure)."""
    leaves: List[Any] = []

    def walk(t):
        if is_leaf is not None and is_leaf(t):
            leaves.append(t)
            return _LEAF
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        if t is None:
            return None
        leaves.append(t)
        return _LEAF

    return leaves, walk(tree)


def unflatten(structure: Any, leaves: List[Any]) -> Any:
    """The inverse of :func:`flatten` (lists come back as lists)."""
    it = iter(leaves)

    def build(s):
        if s is _LEAF:
            return next(it)
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        if isinstance(s, list):
            return [build(v) for v in s]
        return s

    return build(structure)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of ``tree``'s structure down to its leaves)."""
    leaves, structure = flatten(tree, is_leaf)
    others = [flatten_up_to(structure, r) for r in rest]
    return unflatten(structure, [fn(*xs) for xs in zip(leaves, *others)])


def flatten_up_to(structure: Any, tree: Any) -> List[Any]:
    """The subtrees of ``tree`` at the leaves of ``structure``."""
    out: List[Any] = []

    def walk(s, t):
        if s is _LEAF:
            out.append(t)
        elif isinstance(s, dict):
            for k, v in s.items():
                walk(v, t[k])
        elif isinstance(s, list):
            for v, x in zip(s, t):
                walk(v, x)

    walk(structure, tree)
    return out
