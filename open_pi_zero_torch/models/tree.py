"""Helpers over param trees: nested dicts whose leaves are tensors (the
port's counterpart of ``jax.tree.map`` and of walking a stacked layer
tree with ``lax.scan``)."""

from __future__ import annotations

from typing import Callable, List


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every leaf (and the matching leaves of ``rest``,
    trees of the same structure), keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the dict's order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def layer_split(stacked: dict, num_layers: int) -> List[dict]:
    """The ``num_layers`` per-layer trees of a stacked ``[L, ...]`` layer
    tree, as views: one ``torch.unbind`` per leaf. Under autograd the
    backward of an unbind is one ``stack`` of the L layer grads, where
    indexing ``x[i]`` per layer would scatter each layer's grad into its own
    full-size ``[L, ...]`` zero tensor."""
    per_leaf = tree_map(lambda x: x.unbind(0), stacked)
    return [tree_map(lambda views: views[i], per_leaf) for i in range(num_layers)]
