"""Trajectory-level transforms (counterpart of the JAX package's
``data/traj_transforms.py``; reference src/data/traj_transforms.py and the
filter steps of src/data/dataset.py:32-175), in numpy. Each takes a dict
of arrays with a shared leading [T] axis; strings are object arrays of
bytes. Randomness comes from an explicit ``np.random.Generator``."""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

import numpy as np

from open_pi_zero_torch.models.tree import tree_map


def _is_string(x: np.ndarray) -> bool:
    return x.dtype == object or x.dtype.kind in "SU"


def add_pad_mask_dict(traj: dict) -> dict:
    """Mark which observation/task entries are padding: strings -> non-empty,
    tensors -> all-True (reference traj_transforms.py:114-138)."""
    traj_len = len(traj["action"])
    for group in ("observation", "task"):
        if group not in traj:
            continue
        pad_masks = {}
        for key, x in traj[group].items():
            if isinstance(x, dict):
                continue
            if _is_string(x):
                pad_masks[key] = np.asarray([len(s) != 0 for s in x], bool).reshape(x.shape)
            else:
                pad_masks[key] = np.ones(traj_len, bool)
        traj[group] = dict(traj[group])
        traj[group]["pad_mask_dict"] = pad_masks
    return traj


def pad_actions_and_proprio(
    traj: dict,
    max_action_dim: Optional[int] = None,
    max_proprio_dim: Optional[int] = None,
) -> dict:
    """Zero-pad the trailing action/proprio dim and record an
    `action_pad_mask` (reference traj_transforms.py:141-165)."""
    traj["action_pad_mask"] = np.ones_like(traj["action"], bool)
    if max_action_dim is not None:
        dim = traj["action"].shape[-1]
        if dim > max_action_dim:
            raise ValueError(f"action dim {dim} > max_action_dim {max_action_dim}")
        pad = [(0, 0)] * (traj["action"].ndim - 1) + [(0, max_action_dim - dim)]
        traj["action"] = np.pad(traj["action"], pad)
        traj["action_pad_mask"] = np.pad(traj["action_pad_mask"], pad)
    if max_proprio_dim is not None and "proprio" in traj.get("observation", {}):
        dim = traj["observation"]["proprio"].shape[-1]
        if dim > max_proprio_dim:
            raise ValueError(f"proprio dim {dim} > max_proprio_dim {max_proprio_dim}")
        traj["observation"]["proprio"] = np.pad(traj["observation"]["proprio"], [(0, 0), (0, max_proprio_dim - dim)])
    return traj


def chunk_act_obs(traj: dict, window_size: int = 1, action_horizon: int = 1) -> dict:
    """Chunk observations into [T, window] histories (front edge clamped to
    frame 0) and actions into [T, window, horizon, A] chunks (back edge
    clamped to the final action), with `timestep_pad_mask`,
    `task_completed` and the chunk-aware `action_pad_mask`
    (reference traj_transforms.py:12-102)."""
    traj_len = len(traj["action"])

    hist = np.arange(traj_len)[:, None] + np.arange(-window_size + 1, 1)  # [T, W]
    timestep_pad_mask = hist >= 0
    hist = np.maximum(hist, 0)
    traj["observation"] = tree_map(lambda x: x[hist], traj["observation"])
    traj["observation"]["timestep_pad_mask"] = timestep_pad_mask

    if traj["action"].ndim == 2:
        fut = np.arange(traj_len)[:, None] + np.arange(action_horizon)  # [T, H]
        fut = np.minimum(fut, traj_len - 1)
        traj["action"] = traj["action"][fut]  # [T, H, A]
    else:
        if traj["action"].shape[1] < action_horizon:
            raise ValueError(
                f"action_horizon {action_horizon} > pre-chunked dim {traj['action'].shape[1]}"
            )
        traj["action"] = traj["action"][:, :action_horizon]
    traj["action"] = traj["action"][hist]  # [T, W, H, A]

    if "timestep" in traj.get("task", {}):
        goal = traj["task"]["timestep"]
    else:
        goal = np.full(traj_len, traj_len - 1, np.int32)
    t, w, h = np.meshgrid(np.arange(traj_len), np.arange(window_size), np.arange(action_horizon), indexing="ij")
    rel = goal[:, None, None] - (t - (window_size + 1) + w + h)
    traj["observation"]["task_completed"] = rel <= 0

    apm = traj["action_pad_mask"]
    apm = apm[:, None, None, :] if apm.ndim == 2 else apm[:, None, :]
    traj["action_pad_mask"] = apm & ~traj["observation"]["task_completed"][:, :, :, None]
    return traj


def subsample(traj: dict, subsample_length: int, rng: np.random.Generator) -> dict:
    """Randomly keep at most `subsample_length` frames, in the order of a
    random permutation (reference traj_transforms.py:105-111)."""
    traj_len = len(traj["action"])
    if traj_len <= subsample_length:
        return traj
    idx = rng.permutation(traj_len)[:subsample_length]
    return tree_map(lambda x: x[idx], traj)


def has_language(traj: dict) -> bool:
    """skip_unlabeled predicate (reference dataset.py:92-99)."""
    return any(len(s) != 0 for s in traj["task"]["language_instruction"])


def within_action_bounds(traj: dict, max_action: float) -> bool:
    return bool(np.all(np.abs(traj["action"]) <= max_action))


def within_proprio_bounds(traj: dict, max_proprio: float) -> bool:
    return bool(np.all(np.abs(traj["observation"]["proprio"]) <= max_proprio))


def flatten_to_frames(trajectories: Iterable[dict]) -> Iterator[dict]:
    """Trajectories -> their frames, in order (dlimp's flatten)."""
    for traj in trajectories:
        for i in range(len(traj["action"])):
            yield tree_map(lambda x, i=i: x[i], traj)
