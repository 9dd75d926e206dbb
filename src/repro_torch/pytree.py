"""Nested dicts of tensors: the port's params, optimizer state, gradients
and batches.  Their leaves are taken in sorted key order at every level,
the order in which JAX flattens a dict, so two trees with the same keys
give their leaves in the same order whatever order the keys were inserted
in."""

from __future__ import annotations


def paths(tree, path=()):
    """(path, leaf) of every leaf, the path a tuple of dict keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], path + (k,))
    else:
        yield path, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in paths(tree)]


def map(fn, tree):  # noqa: A001 -- the tree's map, as jax.tree.map
    """The tree of the same structure with ``fn(leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unflatten(tree, flat):
    """The tree of ``tree``'s structure with the leaves of ``flat``, given in
    the order of ``leaves(tree)``."""
    it = iter(flat)

    def build(t):
        return {k: build(t[k]) for k in sorted(t)} if isinstance(t, dict) else next(it)

    return build(tree)
