"""Open-X-Embodiment datasets: per-dataset configs, gripper-action
canonicalization, standardization transforms and named mixes (counterpart
of the JAX package's ``data/oxe.py``; reference src/data/oxe/*), in numpy.

This module holds the entries the configs name (``bridge_dataset``,
``fractal20220817_data``; the mixes ``bridge``, ``fractal`` and
``oxe_simple``). The full OXE table and its mixes (``rtx``, ``oxe_magic_soup``
and the rest) come from ``data/oxe_registry.py``, imported at the end of
this module, which merges them in as the JAX package's ``oxe.py`` does. A
name that neither registers raises.
"""

from __future__ import annotations

import copy
import enum
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np

from open_pi_zero_torch.models.tree import tree_map

class ProprioEncoding(enum.Enum):
    NONE = "none"
    POS_EULER = "pos_euler"  # xyz + rpy + gripper(1) [+ pad]
    POS_QUAT = "pos_quat"  # xyz + quat + gripper(1)
    JOINT = "joint"
    JOINT_BIMANUAL = "joint_bimanual"
    POS_NAV = "pos_nav"  # xy + yaw


class ActionEncoding(enum.Enum):
    EEF_POS = "eef_pos"  # xyz delta + rpy delta + gripper(1)
    JOINT_POS = "joint_pos"
    JOINT_POS_BIMANUAL = "joint_pos_bimanual"
    NAV_2D = "nav_2d"
    JOINT_POS_BIMANUAL_NAV = "joint_pos_bimanual_nav"


# --------------------------------------------------------------------------- #
# gripper canonicalization (reference data_utils.py:303-400): the JAX
# package's tf.scan carries, as loops
# --------------------------------------------------------------------------- #


def binarize_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """Continuous [0,1] gripper -> binary {0,1}: intermediate values take
    the next definitive state (a backward carry); a trailing intermediate
    run takes the final raw action."""
    actions = np.asarray(actions, np.float32)
    open_mask = actions > 0.95
    closed_mask = actions < 0.05
    in_between = ~(open_mask | closed_mask)
    is_open = open_mask.astype(np.float32)
    out = np.empty_like(actions)
    carry = actions[-1] if len(actions) else np.float32(0)
    for i in range(len(actions) - 1, -1, -1):
        carry = carry if in_between[i] else is_open[i]
        out[i] = carry
    return out


def rel2abs_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """Relative gripper (+close/-open) -> absolute {0 closed, 1 open}: hold
    the last commanded state through no-change steps; assume initially open
    when no command ever fires."""
    actions = np.asarray(actions)
    cmd = np.where(actions < -0.1, 1, np.where(actions > 0.1, -1, 0)).astype(np.int32)  # +1 open, -1 close
    start = -1 * cmd[np.argmax(cmd != 0)] if len(cmd) else 0
    carry = 1 if start == 0 else start
    states = np.empty(len(cmd), np.int32)
    for i in range(len(cmd)):
        carry = carry if cmd[i] == 0 else cmd[i]
        states[i] = carry
    return states.astype(np.float32) / np.float32(2.0) + np.float32(0.5)


def invert_gripper_actions(actions: np.ndarray) -> np.ndarray:
    return np.float32(1.0) - np.asarray(actions, np.float32)


def relabel_actions_from_proprio(traj: dict, state_key: str = "state") -> dict:
    """Replace xyz+rpy action dims with deltas of reached proprio, dropping
    the final step (reference data_utils.py:403-421)."""
    state = traj["observation"][state_key]
    movement = state[1:, :6] - state[:-1, :6]
    traj = tree_map(lambda x: x[:-1], traj)
    traj["action"] = np.concatenate([movement, traj["action"][:, -1:]], axis=1)
    return traj


# --------------------------------------------------------------------------- #
# standardization transforms
# --------------------------------------------------------------------------- #


def bridge_transform(traj: dict) -> dict:
    """bridge_dataset: binarize gripper, relabel xyz/rpy from reached state,
    proprio = raw state (reference oxe_standardization_transforms.py:27-40)."""
    traj["action"] = np.concatenate(
        [traj["action"][:, :6], binarize_gripper_actions(traj["action"][:, -1])[:, None]],
        axis=1,
    )
    traj = relabel_actions_from_proprio(traj)
    traj["observation"]["proprio"] = traj["observation"]["state"]
    return traj


def rt1_transform(traj: dict) -> dict:
    """fractal20220817_data (RT-1): rel->abs gripper, concat world_vector +
    rotation_delta + gripper; proprio = base_pose_tool_reached +
    gripper_closed (reference :43-68)."""
    grip = rel2abs_gripper_actions(traj["action"]["gripper_closedness_action"][:, 0])
    traj["action"] = np.concatenate(
        [traj["action"]["world_vector"], traj["action"]["rotation_delta"], grip[:, None]],
        axis=-1,
    )
    traj["observation"]["proprio"] = np.concatenate(
        [traj["observation"]["base_pose_tool_reached"], traj["observation"]["gripper_closed"]],
        axis=-1,
    )
    traj["language_instruction"] = traj["observation"]["natural_language_instruction"]
    return traj


def identity_transform(traj: dict) -> dict:
    return traj


STANDARDIZE_FNS: Dict[str, Callable] = {
    "bridge_dataset": bridge_transform,
    "fractal20220817_data": rt1_transform,
}


# --------------------------------------------------------------------------- #
# per-dataset configs (image keys, encodings)
# --------------------------------------------------------------------------- #

REGISTRY: Dict[str, dict] = {
    "bridge_dataset": {
        "image_obs_keys": {"primary": "image_0", "secondary": "image_1", "wrist": None},
        "depth_obs_keys": {"primary": None, "secondary": None, "wrist": None},
        "proprio_encoding": ProprioEncoding.POS_EULER,
        "action_encoding": ActionEncoding.EEF_POS,
    },
    "fractal20220817_data": {
        "image_obs_keys": {"primary": "image", "secondary": None, "wrist": None},
        "depth_obs_keys": {"primary": None, "secondary": None, "wrist": None},
        "proprio_encoding": ProprioEncoding.POS_QUAT,
        "action_encoding": ActionEncoding.EEF_POS,
    },
}


MIXES: Dict[str, List[Tuple[str, float]]] = {
    "bridge": [("bridge_dataset", 1.0)],
    "fractal": [("fractal20220817_data", 1.0)],
    "oxe_simple": [("bridge_dataset", 1.0), ("fractal20220817_data", 1.0)],
}


def action_normalization_mask(encoding: ActionEncoding) -> List[bool]:
    """Gripper dims are excluded from normalization
    (reference oxe/__init__.py:40-62)."""
    if encoding is ActionEncoding.EEF_POS:
        return [True] * 6 + [False]
    if encoding is ActionEncoding.JOINT_POS:
        return [True] * 7 + [False]
    if encoding is ActionEncoding.JOINT_POS_BIMANUAL:
        return [True] * 6 + [False] + [True] * 6 + [False]
    if encoding is ActionEncoding.NAV_2D:
        return [True] * 2
    if encoding is ActionEncoding.JOINT_POS_BIMANUAL_NAV:
        return [True] * 6 + [False] + [True] * 6 + [False] + [True] * 2
    raise ValueError(f"unsupported action encoding {encoding}")


def make_oxe_dataset_kwargs(
    name: str,
    data_dir: str,
    load_camera_views: Sequence[str] = ("primary",),
    load_depth: bool = False,
    load_proprio: bool = True,
    load_language: bool = True,
) -> dict:
    """kwargs for pipeline.make_dataset_from_rlds
    (reference oxe/__init__.py:19-103)."""
    if name not in REGISTRY:
        raise ValueError(f"unknown OXE dataset {name!r}; add it to oxe.REGISTRY")
    cfg = copy.deepcopy(REGISTRY[name])
    # a view mapped to None is valid (padding image, reference
    # oxe/__init__.py:64-69 checks key presence, not None-ness)
    missing = set(load_camera_views) - set(cfg["image_obs_keys"])
    if missing:
        raise ValueError(f"{name} lacks views {missing}")
    kwargs: Dict[str, Any] = {
        "name": name,
        "data_dir": data_dir,
        "image_obs_keys": {k: v for k, v in cfg["image_obs_keys"].items() if k in load_camera_views},
        "standardize_fn": cfg.get("standardize_fn") or STANDARDIZE_FNS.get(name, identity_transform),
        "action_normalization_mask": action_normalization_mask(cfg["action_encoding"]),
    }
    if load_depth:
        kwargs["depth_obs_keys"] = {k: v for k, v in cfg["depth_obs_keys"].items() if k in load_camera_views}
    if load_proprio:
        kwargs["proprio_obs_key"] = "proprio"
    if load_language:
        kwargs["language_key"] = "language_instruction"
    return kwargs


def make_oxe_dataset_kwargs_and_weights(
    mix: str,
    data_dir: str,
    **kwargs,
) -> Tuple[List[dict], List[float]]:
    """(dataset_kwargs_list, sample_weights) for a named mix
    (reference oxe/__init__.py:105-165)."""
    entries = MIXES.get(mix)
    if entries is None:
        if mix in REGISTRY:
            entries = [(mix, 1.0)]
        else:
            raise ValueError(f"unknown mix {mix!r}")
    kwargs_list, weights = [], []
    for name, weight in entries:
        kwargs_list.append(make_oxe_dataset_kwargs(name, data_dir, **kwargs))
        weights.append(weight)
    return kwargs_list, weights


# --------------------------------------------------------------------------- #
# extended registry: the full OXE table and named mixes. data/oxe_registry.py
# uses the helpers above and merges itself into REGISTRY, STANDARDIZE_FNS and
# MIXES when it is imported.
# --------------------------------------------------------------------------- #

from open_pi_zero_torch.data import oxe_registry  # noqa: E402,F401
