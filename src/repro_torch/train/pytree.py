"""Flatten and rebuild the nested dicts and lists that hold parameters and
optimizer state, in ``jax.tree.flatten``'s order for such trees: dict keys
sorted, lists and tuples in index order.  Checkpoints name their leaves by
this order, so a plain tree that the reference saved restores here."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, skeleton): the skeleton is the tree with each leaf replaced
    by its index in ``leaves``."""
    leaves: List[Any] = []

    def skel(node):
        if isinstance(node, dict):
            return {k: skel(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            parts = [skel(v) for v in node]
            return (type(node)(*parts) if hasattr(node, "_fields")
                    else type(node)(parts))
        leaves.append(node)
        return len(leaves) - 1
    return leaves, skel(tree)


def unflatten(skeleton, leaves):
    """The tree of ``skeleton`` with index ``i`` replaced by ``leaves[i]``."""
    if isinstance(skeleton, dict):
        return {k: unflatten(v, leaves) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        parts = [unflatten(v, leaves) for v in skeleton]
        return (type(skeleton)(*parts) if hasattr(skeleton, "_fields")
                else type(skeleton)(parts))
    return leaves[skeleton]


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    flat, skel = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(f"tree structures differ: {len(flat)} leaves "
                             f"against {len(o)}")
    return unflatten(skel, [fn(*xs) for xs in zip(flat, *others)])
