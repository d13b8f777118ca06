"""Tree math over nested dicts, lists and tuples of tensors (the port's
parameter and state trees).

The leaf order is ``jax.tree_util``'s: dict entries in sorted-key
order, list, tuple and NamedTuple entries in order, ``None`` no leaf.
A NamedTuple that names fields in a ``_static`` class attribute keeps
them out of its leaves (the counterpart of pytree aux data, e.g.
``Q8State.size``): they are carried over unchanged by ``tree_map`` and
``tree_unflatten``."""
from __future__ import annotations

import torch


def _children(tree):
    """A NamedTuple's leaf-bearing fields as (name, value) pairs."""
    static = getattr(type(tree), "_static", ())
    return [(f, getattr(tree, f)) for f in tree._fields if f not in static]


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves of a tree in ``jax.tree_util``'s flatten order; a
    subtree for which ``is_leaf`` is true counts as one leaf."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if _is_namedtuple(tree):
        return [x for _, t in _children(tree) for x in tree_leaves(t, is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every leaf; the containers are rebuilt (a
    NamedTuple keeps its type and its static fields)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return tree._replace(**{f: tree_map(fn, t) for f, t in _children(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def tree_unflatten(like, leaves: list):
    """A tree of ``like``'s structure whose leaves, in flatten order,
    are ``leaves`` (the inverse of ``tree_leaves``; a leaf may be
    replaced by a subtree)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if _is_namedtuple(t):
            return t._replace(**{f: build(v) for f, v in _children(t)})
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_param_count(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return int(sum(x.numel() for x in tree_leaves(tree)))


def tree_bytes(tree) -> int:
    """Total bytes of a tree (each leaf's dtype itemsize)."""
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)))


def tree_global_norm(tree) -> torch.Tensor:
    """L2 norm across every leaf of the tree (fp32 accumulation)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    sq = sum(torch.sum(torch.square(x.float())) for x in leaves)
    return torch.sqrt(sq)


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype),
                    tree)


def tree_cast(tree, dtype):
    """Cast all floating leaves to ``dtype``; leave integer leaves alone."""
    return tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, tree)
