"""Nested dicts and lists of tensors: the port's param, optimizer and
checkpoint trees.

A tree is a dict, list or tuple of trees, or a leaf (anything else).
Leaves are visited depth first in dict insertion order, the order every
tree of the port is built in, so two trees of one structure give their
leaves in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(dotted path, leaf)`` pairs: ``layers.3.core.wq.w``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from paths(v, f"{prefix}.{k}" if prefix else str(k))


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in paths(tree)]


def unflatten(tree, new_leaves) -> Any:
    """``tree``'s structure with ``new_leaves`` in its leaves' order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def map_leaves(fn: Callable, tree) -> Any:
    return unflatten(tree, [fn(leaf) for leaf in leaves(tree)])
