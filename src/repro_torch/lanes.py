"""Lane-stacked states: the port's counterpart of ``jax.tree.map`` over the
NamedTuple states (`OuterState`, `ProbeState`, `HyperParams`, ...).

Tensor leaves gain or lose a leading lane axis; ``None`` stays ``None``;
every other field (a kernel or estimator name, a step count) is static and
shared by every lane, as the reference keeps it out of its pytrees or
stacks equal values.
"""
from __future__ import annotations

from typing import Callable

import torch


def tree_map(fn: Callable, *trees):
    """``fn`` over the tensor leaves of NamedTuple trees of one structure;
    static fields are taken from the first tree."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_map(fn, *parts) for parts in zip(*trees)))
    return first


def stack(trees: list):
    """Stack one-system trees on a new leading lane axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def lane(tree, index: int):
    """Lane ``index`` of a lane-stacked tree."""
    return tree_map(lambda v: v[index], tree)
