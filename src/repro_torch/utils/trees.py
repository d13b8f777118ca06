"""Tree math over nested dicts, lists and tuples of tensors (the port's
parameter and state trees)."""
from __future__ import annotations

import torch


def tree_leaves(tree) -> list:
    """The tensors of a tree, dict entries in sorted-key order (the
    order ``jax.tree_util`` flattens a dict in); ``None`` is no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every leaf; the containers are rebuilt (a
    NamedTuple keeps its type)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


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
