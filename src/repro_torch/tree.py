"""Pytrees of tensors: ``NamedTuple``, ``tuple``, ``list`` and ``dict``
nodes with tensor leaves, walked in one fixed order. ``None`` is an
empty subtree, as in ``jax.tree``: it holds no leaf and maps to itself
(Zamba2's ``shared_attn`` positions of a segment hold ``None``)."""

from __future__ import annotations

from collections.abc import Callable
from typing import Any


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over matching pytrees of tensors."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out
