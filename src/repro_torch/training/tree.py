"""Nested-dict trees of tensors, walked in the reference's order.

``jax.tree.leaves`` visits a dict's keys sorted, so the gradient norm's sum
and a checkpoint's key list follow that order; these helpers do the same
for the port's trees (dicts, lists and tuples of tensors or arrays)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def leaves_with_path(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in the reference's order: dict keys sorted, list
    and tuple items by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree) -> List:
    return [leaf for _, leaf in leaves_with_path(tree)]


def path_key(path: Tuple) -> str:
    """A path as the reference's checkpoint names it: its keys joined by
    '/' (``params/blocks/attn/wq``, ``opt/step``)."""
    return "/".join(str(p) for p in path)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(tree, values: List):
    """``tree``'s structure with its leaves, in ``leaves`` order, replaced
    by ``values``."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("unflatten_like: more values than leaves")
    return out
