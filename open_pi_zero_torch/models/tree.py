"""Helpers over param trees: nested dicts whose leaves are tensors (the
port's counterpart of ``jax.tree.map`` and of indexing a stacked layer
tree inside ``lax.scan``)."""

from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf, keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_slice(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked ``[L, ...]`` layer tree, as views."""
    return tree_map(lambda x: x[i], stacked)
