"""Pytrees of tensors: ``NamedTuple``, ``tuple``, ``list`` and ``dict``
nodes with tensor leaves, walked in one fixed order. ``None`` is an
empty subtree, as in ``jax.tree``: it holds no leaf and maps to itself
(Zamba2's ``shared_attn`` positions of a segment hold ``None``).

A leaf's path is a tuple of keys, the kinds ``jax.tree_util`` gives:
:class:`DictKey` for a dict entry, :class:`SequenceKey` for a list or
tuple position and :class:`GetAttrKey` for a NamedTuple field, whose
``str`` are the key, the index and ``.field`` (the checkpoint's and the
sharding rules' names are built from them)."""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any


@dataclasses.dataclass(frozen=True)
class DictKey:
    key: Any

    def __str__(self) -> str:
        return str(self.key)


@dataclasses.dataclass(frozen=True)
class SequenceKey:
    idx: int

    def __str__(self) -> str:
        return str(self.idx)


@dataclasses.dataclass(frozen=True)
class GetAttrKey:
    name: str

    def __str__(self) -> str:
        return f".{self.name}"


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any, path: tuple = ()) -> Any:
    """Apply ``fn(path, leaf, *other_leaves)`` leafwise over matching pytrees."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(tree_map_with_path(fn, *xs, path=path + (GetAttrKey(f),))
                            for f, *xs in zip(tree._fields, tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, *xs, path=path + (SequenceKey(i),))
                          for i, xs in enumerate(zip(tree, *rest)))
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest), path=path + (DictKey(k),))
                for k in tree}
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over matching pytrees of tensors (the walk of
    :func:`tree_map_with_path` without building paths: the engine's and
    the server's loops call it every round)."""
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


def tree_leaves_with_path(tree: Any) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs in leaf order."""
    out: list = []
    tree_map_with_path(lambda p, a: out.append((p, a)), tree)
    return out
