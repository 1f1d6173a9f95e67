"""Walkers over the port's parameter trees: nested dicts, lists (the
layer stacks) and tuples of tensors or quantized leaves.

:func:`tree_leaves` gives the leaves in the JAX package's flatten order
(dict keys sorted). Where JAX holds a layer stack as one ``(L, …)`` leaf,
the port holds a list of L layers under one of :data:`STACK_FRAGMENTS`.
"""
from __future__ import annotations

#: path fragments marking stacked per-layer parameter groups
STACK_FRAGMENTS = ("layers", "moe_layers", "groups", "tail",
                   "enc_layers", "dec_layers")


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples (None is empty),
    in the JAX package's flatten order: dict keys sorted."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of each tree of ``rest``
    (the same structure), into ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def tree_to(params, device):
    """Move every tensor and quantized leaf of a tree to ``device``."""
    if isinstance(params, dict):
        return {k: tree_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [tree_to(v, device) for v in params]
    return params.to(device)
