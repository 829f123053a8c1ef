"""Nested parameter trees (dicts and lists of tensors) in the reference's
leaf order.

The reference flattens a model with ``jax.tree.leaves``: dict keys sorted
at every level, lists in index order. Every flat vector of the port (the
CSR column indices, chunk bounds, the (K, N) stacks) follows that order,
so that a column means the same parameter in both packages. A flat
``{name: tensor}`` dict, the paper CNN's tree, is the one-level case.

Joining path names with ``/`` and sorting the joined strings is not the
same order: a list index 10 would sort before 2, and ``a/b`` before
``a_b`` differently from ``a`` before ``a_b``.
"""
from __future__ import annotations


def leaves_with_path(tree, path=()):
    """``[(path, leaf), ...]`` in ``jax.tree.leaves`` order; a path is the
    tuple of dict keys and list indices that leads to the leaf."""
    if isinstance(tree, dict):
        return [lp for k in sorted(tree)
                for lp in leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [lp for i, v in enumerate(tree)
                for lp in leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def leaves(tree):
    """The leaves in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def path_name(path):
    """A leaf path as the reference names it (``param_layout._path_name``):
    its keys and indices joined by ``/``."""
    return "/".join(str(p) for p in path)


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def from_leaves(template, values):
    """``template``'s structure holding ``values``, given in
    ``jax.tree.leaves`` order."""
    it = iter(values)
    return tree_map(lambda _: next(it), template)
