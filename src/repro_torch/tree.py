"""Nested dicts and lists of tensors (the reference's pytrees), walked in
the reference's order.

``jax.tree`` visits a dict's keys sorted and a list's items in order; the
optimizers (``global_norm`` sums leaves in that order) and the checkpoint
layout (one file per key path, ``"params/bottom/0/w"``) both depend on it.
Anything that is not a ``Mapping``, list or tuple is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Mapping, Tuple


def flatten(tree) -> Tuple[List[Tuple], List[Any]]:
    """(key paths, leaves) in the reference's order."""
    paths, leaves = [], []

    def walk(node, path):
        if isinstance(node, Mapping):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            paths.append(path)
            leaves.append(node)

    walk(tree, ())
    return paths, leaves


def leaves(tree) -> List[Any]:
    return flatten(tree)[1]


def key_of(path: Tuple) -> str:
    """The reference checkpoint's key of a path: its parts joined by ``/``."""
    return "/".join(str(p) for p in path)


def unflatten(like, new_leaves) -> Any:
    """A tree shaped as ``like`` holding ``new_leaves`` (in ``flatten``'s order)."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, Mapping):
            out = {}
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``,
    which must have the same key paths."""
    paths, xs = flatten(tree)
    others = []
    for other in rest:
        p, ys = flatten(other)
        if p != paths:
            raise ValueError("trees differ in structure")
        others.append(ys)
    return unflatten(tree, [fn(*args) for args in zip(xs, *others)])
