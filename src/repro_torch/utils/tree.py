"""Helpers over parameter trees: nested dicts, lists and tuples of tensors
(the port's counterpart of ``repro/utils/tree.py`` and of
``jax.tree_util``)."""
from __future__ import annotations

from typing import Callable, Iterator, List

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _iter_leaves(tree) -> Iterator:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _iter_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _iter_leaves(v)
    else:
        yield tree


def tree_leaves(tree) -> List:
    """The leaves in a fixed order (dict insertion order, then list order)."""
    return list(_iter_leaves(tree))


def tree_unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in ``tree_leaves``
    order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_global_norm(tree) -> torch.Tensor:
    """Global L2 norm over all leaves, in float32, as a 0-d tensor."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree)))
