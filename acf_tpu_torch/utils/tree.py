"""Trees of dicts, lists and tuples with tensor leaves: the port's params,
optimizer slots and masks are such trees (the shapes of the JAX pytrees).
Dicts are walked in insertion order."""

from __future__ import annotations


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    """The leaves in the order :func:`tree_map` visits them."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """``leaves`` (in :func:`tree_leaves` order) in the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
