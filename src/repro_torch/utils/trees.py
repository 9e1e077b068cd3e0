"""Small helpers over the port's trees: a tensor, or dicts, lists and
tuples (NamedTuples included) of them, nested; ``None`` is an empty
subtree, as in a JAX pytree.  Port of ``src/repro/utils/trees.py``.

Leaves are visited in the JAX package's order: a dict's keys sorted, a
sequence's items in order.  Paths (:func:`tree_leaves_with_path`) are
the JAX package's ``/``-joined key and index strings, such as
``seg0/mixer/wq/w``.
"""
from __future__ import annotations

import torch


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_map(fn, tree, *rest):
    """``fn`` on every leaf of ``tree`` (with the matching leaves of the
    trees of ``rest``, which share its structure)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if _is_namedtuple(tree) else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves_with_path(tree, prefix: str = ""):
    """``[(path, leaf)]`` in the JAX package's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    return [pl for k, v in items
            for pl in tree_leaves_with_path(v, f"{prefix}/{k}" if prefix
                                            else k)]


def tree_leaves(tree):
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` on every leaf, paths as in
    :func:`tree_leaves_with_path`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix
                                      else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, f"{prefix}/{i}" if prefix
                                  else str(i))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if _is_namedtuple(tree) else type(tree)(out)
    return fn(prefix, tree)


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in
    :func:`tree_leaves`' order, by those of the sequence ``leaves``."""
    it = iter(leaves)
    missing = object()

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            out = [build(v) for v in node]
            return type(node)(*out) if _is_namedtuple(node) else \
                type(node)(out)
        leaf = next(it, missing)
        if leaf is missing:
            raise ValueError("fewer leaves than the tree has")
        return leaf
    out = build(like)
    if next(it, missing) is not missing:
        raise ValueError("more leaves than the tree has")
    return out


def tree_size(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes of a tree's tensors (meta tensors count as well)."""
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_axpy(a, x, y):
    """a*x + y, leafwise."""
    return tree_map(lambda xi, yi: a * xi + yi, x, y)


def tree_dot(a, b):
    """Inner product of two trees: the sum of each pair of leaves'
    elementwise products, summed over the leaves in order."""
    dots = [torch.sum(x * y) for x, y in zip(tree_leaves(a), tree_leaves(b),
                                             strict=True)]
    total = dots[0]
    for d in dots[1:]:
        total = total + d
    return total


def tree_norm(a):
    return torch.sqrt(tree_dot(a, a))


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)
