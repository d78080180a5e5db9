"""Task-spec augmentation: instruction rephrasing from a paraphrase table,
and random goal-image / language dropout (counterpart of the JAX package's
``data/task_augmentation.py``; reference
src/data/utils/task_augmentation.py, Octo extras kept for capability
parity; the π0 configs do not enable them), in numpy with an explicit
generator. The paraphrase table is a local .json or .pkl file, as in the
JAX package."""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Optional

import numpy as np


def to_padding(x: np.ndarray) -> np.ndarray:
    if x.dtype == object or x.dtype.kind in "SU":
        out = np.empty(x.shape, object)
        out[...] = b""
        return out
    return np.zeros_like(x)


def load_paraphrase_table(path: str) -> Dict[str, str]:
    """{original: "alt1.alt2..."} mapping from a local .json or .pkl file."""
    with open(path, "rb") as f:
        if os.path.splitext(path)[1] == ".json":
            return json.load(f)
        return pickle.load(f)


class Rephraser:
    def __init__(self, table: Dict[str, str]):
        self.table = {_bytes(k): _bytes(v) for k, v in table.items()}

    @classmethod
    def from_file(cls, path: str) -> "Rephraser":
        return cls(load_paraphrase_table(path))


def _bytes(s) -> bytes:
    return s if isinstance(s, bytes) else str(s).encode()


def rephrase_instruction(traj: dict, rephraser: Rephraser, rephrase_prob: float,
                         rng: Optional[np.random.Generator] = None) -> dict:
    """With prob `rephrase_prob` swap the instruction for one sampled
    uniformly per step from 'original.alt1.alt2...' (the table's value
    appended to the original, '.'-separated)."""
    if not rephraser.table or "language_instruction" not in traj.get("task", {}):
        return traj
    rng = rng if rng is not None else np.random.default_rng()
    original = traj["task"]["language_instruction"]
    if not all(len(s) > 0 for s in original):
        return traj
    alts = rephraser.table.get(_bytes(original[0]), b"")
    pool = _bytes(original[0]) + b"." + alts if alts else _bytes(original[0])
    candidates = pool.split(b".")
    idx = rng.integers(0, len(candidates), size=len(original))
    if rng.random() < rephrase_prob:
        sampled = np.empty(len(original), object)
        sampled[:] = [candidates[i] for i in idx]
        traj["task"]["language_instruction"] = sampled
    return traj


def delete_task_conditioning(traj: dict, keep_image_prob: float, rng: Optional[np.random.Generator] = None) -> dict:
    """Per step keep EITHER the goal images (prob keep_image_prob) OR the
    language instruction, zero-padding the dropped modality and its pad
    mask. No-op unless both modalities are present."""
    task = traj.get("task", {})
    if "language_instruction" not in task:
        return traj
    image_keys = {k for k in task if k.startswith("image_") or k.startswith("depth_")}
    if not image_keys:
        return traj
    rng = rng if rng is not None else np.random.default_rng()
    traj_len = len(traj["action"])
    keep_images = rng.random(traj_len) < keep_image_prob
    keep_images |= ~task["pad_mask_dict"]["language_instruction"]

    for key in image_keys | {"language_instruction"}:
        keep = keep_images if key in image_keys else ~keep_images
        shaped = keep.reshape(keep.shape + (1,) * (task[key].ndim - 1))
        task[key] = np.where(shaped, task[key], to_padding(task[key]))
        task["pad_mask_dict"][key] = np.where(keep, task["pad_mask_dict"][key], False)

    if "timestep" in task:
        task["timestep"] = np.where(keep_images, task["timestep"], traj_len - 1)
    return traj


def delete_and_rephrase(traj: dict, paraphrases_path: str, rephrase_prob: float, keep_image_prob: float,
                        rng: Optional[np.random.Generator] = None) -> dict:
    rng = rng if rng is not None else np.random.default_rng()
    traj = rephrase_instruction(traj, Rephraser.from_file(paraphrases_path), rephrase_prob, rng)
    return delete_task_conditioning(traj, keep_image_prob, rng)
