"""Dataset statistics and action/proprio normalization (counterpart of the
JAX package's ``data/normalization.py``; reference
src/data/utils/data_utils.py:86-300), in numpy.

Schema of the reference JSONs (configs/statistics/*.json):
{action|proprio: {mean, std, max, min, p99, p01}, num_transitions,
num_trajectories}, possibly keyed by a dataset path at the top level. The
statistics are float64 sums over every trajectory; computed ones are cached
as JSON keyed by a hash of (dataset dir, transform fingerprint), under
``$XDG_CACHE_HOME/open_pi_zero_torch`` (default ``~/.cache``) unless a
cache directory is given.

``normalize_traj`` computes in float32 with the statistics rounded to
float32, as the JAX package's ``tf.constant(v, tf.float32)`` does, so its
outputs are bitwise the JAX package's.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Iterable, Optional

import numpy as np

NORMAL = "normal"
BOUNDS = "bounds"


def compute_statistics(trajectories: Iterable[dict], keys=("action", "proprio")) -> dict:
    """One full pass over trajectories: per-dim stats of action and
    observation/proprio."""
    acc = {k: [] for k in keys}
    n_transitions = 0
    n_trajs = 0
    for traj in trajectories:
        n_trajs += 1
        n_transitions += len(traj["action"])
        acc["action"].append(np.asarray(traj["action"], np.float64))
        if "proprio" in keys and "proprio" in traj.get("observation", {}):
            acc["proprio"].append(np.asarray(traj["observation"]["proprio"], np.float64))
    out = {"num_transitions": n_transitions, "num_trajectories": n_trajs}
    for k, chunks in acc.items():
        if not chunks:
            continue
        x = np.concatenate(chunks, axis=0)
        out[k] = {
            "mean": x.mean(0).tolist(),
            "std": x.std(0).tolist(),
            "max": x.max(0).tolist(),
            "min": x.min(0).tolist(),
            "p99": np.percentile(x, 99, 0).tolist(),
            "p01": np.percentile(x, 1, 0).tolist(),
        }
    return out


def statistics_cache_path(data_dir: str, fingerprint: str, cache_dir: Optional[str] = None) -> str:
    h = hashlib.sha256(f"{os.path.abspath(data_dir)}::{fingerprint}".encode()).hexdigest()[:16]
    if cache_dir is None:
        root = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
        cache_dir = os.path.join(root, "open_pi_zero_torch")
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"statistics_{h}.json")


def get_or_compute_statistics(
    trajectories: Iterable[dict],
    data_dir: str,
    fingerprint: str,
    cache_dir: Optional[str] = None,
    force: bool = False,
) -> dict:
    """The cached statistics, or ``compute_statistics`` over
    ``trajectories`` (iterated only then), written to the cache."""
    path = statistics_cache_path(data_dir, fingerprint, cache_dir)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    stats = compute_statistics(trajectories)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(stats, f)
    os.replace(tmp, path)  # a reader never sees half a file
    return stats


def load_statistics_file(path: str, dataset_name: Optional[str] = None) -> dict:
    """Load a statistics JSON; reference files may key stats by dataset
    path (configs/statistics/*.json top-level key)."""
    with open(path) as f:
        stats = json.load(f)
    if "action" not in stats:
        if dataset_name is not None and dataset_name in stats:
            stats = stats[dataset_name]
        else:
            stats = next(iter(stats.values()))
    return stats


def normalize_traj(
    traj: dict,
    stats: dict,
    normalization_type: str = BOUNDS,
    action_mask: Optional[np.ndarray] = None,
    proprio_mask: Optional[np.ndarray] = None,
) -> dict:
    """Normalize traj["action"] and traj["observation"]["proprio"]
    (reference normalize_action_and_proprio, data_utils.py:250-300); a new
    dict, the input is not changed.

    BOUNDS: x -> clip(2*(x - p01)/(p99 - p01 + 1e-8) - 1, -1, 1)
    NORMAL: x -> (x - mean)/(std + 1e-8)
    Masked-out dims (the gripper) pass through unchanged."""

    def norm(x, s, mask):
        x = np.asarray(x, np.float32)
        s = {k: np.asarray(v, np.float32) for k, v in s.items() if k != "mask"}
        keep = np.ones_like(s["mean"], bool) if mask is None else np.asarray(mask, bool)
        if normalization_type == NORMAL:
            y = (x - s["mean"]) / (s["std"] + np.float32(1e-8))
        elif normalization_type == BOUNDS:
            y = np.clip(
                np.float32(2.0) * (x - s["p01"]) / (s["p99"] - s["p01"] + np.float32(1e-8)) - np.float32(1.0),
                np.float32(-1.0), np.float32(1.0),
            )
        else:
            raise ValueError(f"unknown normalization type {normalization_type}")
        return np.where(keep, y, x)

    traj = dict(traj)
    traj["action"] = norm(traj["action"], stats["action"], action_mask)
    if "proprio" in traj.get("observation", {}) and "proprio" in stats:
        obs = dict(traj["observation"])
        obs["proprio"] = norm(obs["proprio"], stats["proprio"], proprio_mask)
        traj["observation"] = obs
    return traj


def denormalize(
    x: np.ndarray,
    stats: dict,
    normalization_type: str = BOUNDS,
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Host-side inverse used by env adapters (reference env_adapter/base.py)."""
    x = np.asarray(x, np.float64)
    mask = np.ones(x.shape[-1], bool) if mask is None else np.asarray(mask, bool)
    if normalization_type == BOUNDS:
        p01 = np.asarray(stats["p01"])
        p99 = np.asarray(stats["p99"])
        y = (x + 1.0) / 2.0 * (p99 - p01 + 1e-8) + p01
    elif normalization_type == NORMAL:
        y = x * (np.asarray(stats["std"]) + 1e-8) + np.asarray(stats["mean"])
    else:
        raise ValueError(f"unknown normalization type {normalization_type}")
    return np.where(mask, y, x)
