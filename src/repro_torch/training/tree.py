"""Pytree helpers over the port's param and optimizer trees: nested
dicts, lists and tuples of tensors. Dict keys are visited in sorted order,
as ``jax.tree_util`` flattens a dict, so leaf lists line up with the JAX
package's."""

from __future__ import annotations

from typing import Any, Callable, List


def _is_node(t) -> bool:
    return isinstance(t, (dict, list, tuple)) and not hasattr(t, "_fields")


def tree_map(fn: Callable, *trees) -> Any:
    """``fn`` over the leaves of trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in sorted(t0)}
    if _is_node(t0):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves) -> Any:
    """``tree``'s structure with its leaves replaced, in ``tree_leaves``
    order, by ``leaves``."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
