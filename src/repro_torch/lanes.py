"""Trees of tensors and lane-stacked states: the port's counterpart of
``jax.tree.map`` over the states (`OuterState`, `ProbeState`,
`HyperParams`, ...) and the containers they are made of (NamedTuples,
tuples, lists and dicts).

Tensors are the leaves, and so is any object whose class sets
``tree_leaf = True`` (a row-sharded tensor). ``None`` stays ``None``; every
other value (a kernel or estimator name, a step count) is static and shared
by every lane, as the reference keeps it out of its pytrees or stacks equal
values. Lane-stacked leaves gain or lose a leading lane axis.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def is_leaf(x: Any) -> bool:
    return isinstance(x, torch.Tensor) or getattr(x, "tree_leaf", False)


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of trees of one structure; static values are
    taken from the first tree."""
    first = trees[0]
    if is_leaf(first):
        return fn(*trees)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_map(fn, *parts) for parts in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *parts) for parts in zip(*trees))
    if isinstance(first, dict):
        return {k: tree_map(fn, v, *(t[k] for t in trees[1:]))
                for k, v in first.items()}
    return first


def map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` at every leaf; ``path`` holds the field names,
    indices and keys from the root, as ``tree_map_with_path``'s key path."""
    if is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return tree


def stack(trees: list):
    """Stack one-system trees on a new leading lane axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def lane(tree, index: int):
    """Lane ``index`` of a lane-stacked tree."""
    return tree_map(lambda v: v[index], tree)
