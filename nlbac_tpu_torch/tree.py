"""Nested parameter containers: dicts of lists of tensors, as the JAX
package's pytrees (``{"w": [...], "b": [...]}``, nested by name).

Leaves are visited with dict keys in sorted order and lists in order, the
order ``jax.tree.leaves`` uses, so a flat list of leaves lines up with the
reference's."""

from __future__ import annotations

from typing import Any, Callable, List


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


def detach(tree):
    """The same parameters without gradient tracking (a stop-gradient)."""
    return tree_map(lambda p: p.detach(), tree)
