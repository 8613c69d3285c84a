"""Nested dict/list/tuple trees of tensors: the JAX package's pytrees
(parameters, statistics, optimizer state, batches)."""
from __future__ import annotations


def tree_map(fn, *trees):
    """``fn`` over the leaves of ``trees`` (same nesting) as a new tree."""
    a = trees[0]
    if isinstance(a, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves_with_path(tree, path=()):
    """Yield (path, leaf) in the tree's order; a path is a tuple of dict
    keys and list indices."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree):
    return [leaf for _, leaf in tree_leaves_with_path(tree)]
