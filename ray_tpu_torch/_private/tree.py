"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Leaves are visited in sorted-key order, the order ``jax.tree_util`` uses
for dicts, so sums over leaves (the global gradient norm) add in the same
order as the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key]) for key in sorted(tree)}
    return fn(tree)


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in tree_leaves order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
