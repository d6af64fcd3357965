"""Nested-dict trees: the part of ``jax.tree_util`` the port's training
plane needs.

A tree is a dict of trees or a leaf (a tensor, an array, a scalar).  Leaves
come out in jax's order for dicts — keys sorted — and are named as
``jax.tree_util.keystr`` names them (``['params']['embed']['table']``), so
a checkpoint manifest written by either package names the same leaf the
same way.
"""

from __future__ import annotations

from typing import Any, Callable

PyTree = Any


def keystr(path: tuple[str, ...]) -> str:
    return "".join(f"[{k!r}]" for k in path)


def flatten_with_path(tree: PyTree, path: tuple[str, ...] = ()) -> list[tuple[tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in flatten_with_path(tree[k], path + (k,))]
    return [(path, tree)]


def leaves(tree: PyTree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leaf by leaf over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def map_with_path(fn: Callable, tree: PyTree, path: tuple[str, ...] = ()) -> PyTree:
    """``fn(path, leaf)`` for every leaf, keeping the structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)
