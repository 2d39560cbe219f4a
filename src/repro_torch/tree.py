"""Nested containers of tensors, the port's pytrees: dicts (flattened in
sorted key order, as `jax.tree.flatten` orders them), tuples and lists."""
from __future__ import annotations

from typing import Any, Callable


def tree_flatten(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """[(key path, leaf)] in the reference's leaf order; a path holds dict
    keys and sequence indices."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_flatten(tree[k], prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, t in enumerate(tree) for kv in tree_flatten(t, prefix + (i,))]
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_flatten(tree)]


def tree_unflatten(like: Any, leaves) -> Any:
    """The structure of ``like`` holding ``leaves`` (in `tree_flatten`'s order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(tree, [fn(*args) for args in zip(tree_leaves(tree), *others)])
