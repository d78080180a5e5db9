"""Goal relabeling for BC-style training (counterpart of the JAX package's
``data/goal_relabeling.py``; reference src/data/utils/goal_relabeling.py,
an Octo extra kept for capability parity; the π0 configs do not enable it),
in numpy with an explicit generator."""

from __future__ import annotations

from typing import Optional

import numpy as np

from open_pi_zero_torch.models.tree import tree_leaves, tree_map


def tree_merge(*trees: dict) -> dict:
    """Later trees override earlier ones, recursively."""
    merged: dict = {}
    for tree in trees:
        for k, v in tree.items():
            if isinstance(v, dict):
                merged[k] = tree_merge(merged.get(k, {}), v)
            else:
                merged[k] = v
    return merged


def uniform(traj: dict, max_goal_distance: Optional[int] = None, rng: Optional[np.random.Generator] = None) -> dict:
    """For every step i pick a goal index uniformly from [i, traj_len)
    (optionally capped at i + max_goal_distance) and mirror the goal
    observation into `task`."""
    rng = rng if rng is not None else np.random.default_rng()
    traj_len = len(tree_leaves(traj["observation"])[0])
    rand = rng.random(traj_len, dtype=np.float32)
    low = np.arange(traj_len, dtype=np.float32)
    if max_goal_distance is not None:
        high = np.minimum(np.arange(traj_len) + max_goal_distance, traj_len).astype(np.float32)
    else:
        high = np.float32(traj_len)
    goal_idxs = np.minimum((rand * (high - low) + low).astype(np.int32), traj_len - 1)
    goal = tree_map(lambda x: x[goal_idxs], traj["observation"])
    traj["task"] = tree_merge(traj.get("task", {}), goal)
    return traj
