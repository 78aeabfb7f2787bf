"""Nested containers: dicts of lists (or tuples) of tensors, as the JAX
package's pytrees (``{"w": [...], "b": [...]}``, nested by name).

Leaves are visited with dict keys in sorted order and lists in order, the
order ``jax.tree.leaves`` uses, so a flat list of leaves lines up with the
reference's."""

from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, sub, *(r[i] for r in rest))
                          for i, sub in enumerate(tree))
    return fn(tree, *rest)


def _keep_mark(q, p):
    """``q`` with ``p``'s tensor-parallel mark (``nn.mlp.TPShard``)."""
    shard = getattr(p, "tp_shard", None)
    if shard is not None:
        q.tp_shard = shard
    return q


def detach_leaf(p, requires_grad: bool = False):
    """``p`` without its graph (a new leaf that tracks gradients when
    ``requires_grad``), keeping its tensor-parallel mark."""
    q = p.detach()
    if requires_grad:
        q.requires_grad_(True)
    return _keep_mark(q, p)


def detach(tree):
    """The same parameters without gradient tracking (a stop-gradient),
    each keeping its tensor-parallel mark."""
    return tree_map(detach_leaf, tree)


def snapshot(tree):
    """A detached copy of every leaf, each keeping its tensor-parallel
    mark: a stop-gradient that in-place steps of the parameters leave as
    it was."""
    return tree_map(lambda p: _keep_mark(p.detach().clone(), p), tree)


def where_seeds(mask: torch.Tensor, new: torch.Tensor,
                old: torch.Tensor) -> torch.Tensor:
    """``new`` for the seeds where ``mask`` ((S,) bool) holds, ``old`` for
    the others, along a leading seed axis."""
    return torch.where(mask.view((-1,) + (1,) * (new.dim() - 1)), new, old)


class SeedMasks:
    """Host lists of per-seed flags as (S,) bool tensors on ``device``; a
    run repeats a few patterns, so each is copied to the device once."""

    def __init__(self, device):
        self.device, self._masks = device, {}

    def __call__(self, on) -> torch.Tensor:
        key = tuple(bool(o) for o in on)
        if key not in self._masks:
            self._masks[key] = torch.tensor(key, dtype=torch.bool,
                                            device=self.device)
        return self._masks[key]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure whose leaves, in ``tree_leaves``
    order, are ``leaves``."""
    it = iter(leaves)
    end = object()

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        return next(it)

    out = build(tree)
    if next(it, end) is not end:
        raise ValueError("more leaves than the tree has")
    return out
