"""Walking nested carries: the one place that knows their containers.

A tree is a tensor, or a dict, list, tuple or dataclass of trees; any
other leaf (None, a host number, a generator) is carried as it is.  The
rollout's copies, the env's per-env select, the mesh's sharding, the
resume bundle and the host drain all walk trees through ``flatten``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import torch


def _flatten(tree, leaves: list) -> Callable[[Iterator], object]:
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return next
    if isinstance(tree, dict):
        parts = {k: _flatten(v, leaves) for k, v in tree.items()}
        return lambda it: {k: part(it) for k, part in parts.items()}
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v, leaves) for v in tree]
        return lambda it: type(tree)(part(it) for part in parts)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        parts = {f.name: _flatten(getattr(tree, f.name), leaves)
                 for f in dataclasses.fields(tree) if f.init}
        return lambda it: dataclasses.replace(
            tree, **{k: part(it) for k, part in parts.items()})
    return lambda it: tree


def flatten(tree) -> tuple[list, Callable[[Iterator], object]]:
    """``(leaves, rebuild)``: the tensors of ``tree`` in a fixed order,
    and a function that rebuilds the tree from an iterator, taking one
    item from it for each leaf in that order (so several trees flattened
    into one list rebuild from one iterator, each in turn)."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def tree_map(fn, tree, *rest):
    """``tree`` with ``fn(x, *ys)`` in place of each tensor ``x``, the
    ``ys`` the tensors at the same places of the trees ``rest`` (which
    hold as many)."""
    leaves, rebuild = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return rebuild(iter([fn(*xs) for xs in zip(leaves, *others,
                                               strict=True)]))
