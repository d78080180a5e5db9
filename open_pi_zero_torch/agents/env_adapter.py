"""Environment adapters (counterpart of the JAX package's
``agents/env_adapter.py``): numpy host-side glue between a SimplerEnv
observation dict and the model's inputs, and back from normalized action
chunks to simulator commands.

Behavioral parity with the reference adapters
(src/agent/env_adapter/base.py:8-49, simpler.py:16-253): outputs are
plain numpy arrays, and the image path keeps the reference's Lanczos-4
resize, bitwise ``cv2.resize(..., INTER_LANCZOS4)``, through the port's
numpy ``utils.image.resize_lanczos4`` (OpenCV is not a dependency), so
Simpler success rates transfer. ``simpler_env`` is imported only for
real Simpler tasks.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np

from open_pi_zero_torch.data.normalization import load_statistics_file
from open_pi_zero_torch.envs import warm_tokenizer
from open_pi_zero_torch.processing import FakeTokenizer, VLAProcessor, load_paligemma_tokenizer
from open_pi_zero_torch.utils.geometry import euler2axangle, mat2euler, quat2mat
from open_pi_zero_torch.utils.image import resize_lanczos4

log = logging.getLogger(__name__)


class BaseEnvAdapter:
    """Normalization helpers (reference env_adapter/base.py:8-49)."""

    @staticmethod
    def normalize_bound(data, data_min, data_max, clip_min=-1.0, clip_max=1.0, eps=1e-8):
        ndata = 2.0 * (data - data_min) / (data_max - data_min + eps) - 1.0
        return np.clip(ndata, clip_min, clip_max)

    @staticmethod
    def denormalize_bound(data, data_min, data_max, clip_min=-1.0, clip_max=1.0):
        clip_range = clip_max - clip_min
        return (data - clip_min) / clip_range * (data_max - data_min) + data_min

    @staticmethod
    def normalize_gaussian(data, mean, std, eps=1e-8):
        return (data - mean) / (std + eps)

    @staticmethod
    def denormalize_gaussian(data, mean, std, eps=1e-8):
        return data * (std + eps) + mean


def _get_simpler_image(env, obs: dict) -> np.ndarray:
    # in-repo envs (envs/reach_env.py) carry the frame in the obs dict and
    # expose it via env.get_image; real Simpler tasks go through the
    # maniskill camera tree
    if hasattr(env, "get_image"):
        return env.get_image(obs)
    from simpler_env.utils.env.observation_utils import (
        get_image_from_maniskill2_obs_dict,
    )

    return get_image_from_maniskill2_obs_dict(env, obs)


class SimplerAdapter(BaseEnvAdapter):
    """Common Simpler preprocessing/postprocessing
    (reference simpler.py:16-152)."""

    def __init__(
        self,
        dataset_statistics_path: str,
        num_image_tokens: int,
        image_size: Tuple[int, int],
        max_seq_len: int,
        pretrained_model_path: Optional[str] = None,
        tokenizer_padding: str = "max_length",
        action_normalization_type: str = "bound",
        proprio_normalization_type: str = "bound",
        tokenizer=None,
        image_token_index: int = 257152,
        pad_proprio_to: Optional[int] = None,
    ):
        for kind in (action_normalization_type, proprio_normalization_type):
            if kind not in ("bound", "gaussian"):
                raise ValueError(f"unknown normalization type {kind!r}; known: bound, gaussian")
        self.image_size = tuple(image_size)
        self.action_normalization_type = action_normalization_type
        self.proprio_normalization_type = proprio_normalization_type
        # for cross-family multi-task policies: zero-pad the normalized
        # proprio to the model's width, mirroring the training pipeline's
        # normalize-then-pad order (traj_transforms.pad_actions_and_proprio)
        self.pad_proprio_to = pad_proprio_to

        self.dataset_statistics = load_statistics_file(dataset_statistics_path)

        if tokenizer is None:
            path = os.path.expanduser(str(pretrained_model_path)) if pretrained_model_path else None
            if path and os.path.exists(path):
                # raises: the PaliGemma tokenizer needs transformers
                tokenizer = load_paligemma_tokenizer(path)
            else:
                # config-driven SimplerLite runs without hub access use the
                # deterministic word-level FakeTokenizer, pre-warmed so
                # train/eval vocabularies agree
                log.warning("pretrained_model_path missing; using FakeTokenizer (SimplerLite/eval smoke only)")
                tokenizer = FakeTokenizer(image_token_id=int(image_token_index))
                warm_tokenizer(tokenizer)
        self.processor = VLAProcessor(
            tokenizer,
            num_image_tokens=num_image_tokens,
            max_seq_len=max_seq_len,
            tokenizer_padding=tokenizer_padding,
        )

    def reset(self):
        pass

    def resize_image(self, image: np.ndarray) -> np.ndarray:
        return resize_lanczos4(image, self.image_size)

    def preprocess(self, env, obs: dict, instruction: str) -> dict:
        """obs dict -> model inputs {input_ids, pixel_values NHWC f32,
        attention_mask, proprios [1, 1, dim]} (reference simpler.py:53-99;
        euler angles use the sxyz convention)."""
        image = self.resize_image(_get_simpler_image(env, obs))
        model_inputs = self.processor([instruction], image[None])

        raw_proprio = self.preprocess_proprio(obs)
        stats = self.dataset_statistics["proprio"]
        if self.proprio_normalization_type == "bound":
            proprio = self.normalize_bound(
                raw_proprio, np.asarray(stats["p01"]), np.asarray(stats["p99"])
            )
        else:
            proprio = self.normalize_gaussian(
                raw_proprio, np.asarray(stats["mean"]), np.asarray(stats["std"])
            )

        proprio = np.asarray(proprio, np.float32)
        if self.pad_proprio_to is not None and proprio.shape[-1] < self.pad_proprio_to:
            proprio = np.concatenate(
                [proprio, np.zeros(self.pad_proprio_to - proprio.shape[-1], np.float32)]
            )
        model_inputs["proprios"] = proprio[None, None]
        return model_inputs

    def postprocess(self, actions: np.ndarray) -> np.ndarray:
        """Normalized action chunk [A, 7] -> simpler commands [A, 7]
        (xyz delta, axis-angle rotation, gripper; reference
        simpler.py:101-142). The gripper dim is NOT denormalized (it was
        never normalized in training)."""
        stats = self.dataset_statistics["action"]
        if self.action_normalization_type == "bound":
            raw_except_gripper = self.denormalize_bound(
                actions[:, :-1],
                np.asarray(stats["p01"])[:-1],
                np.asarray(stats["p99"])[:-1],
            )
        else:
            raw_except_gripper = self.denormalize_gaussian(
                actions[:, :-1],
                np.asarray(stats["mean"])[:-1],
                np.asarray(stats["std"])[:-1],
            )
        raw_actions = np.concatenate([raw_except_gripper, actions[:, -1:]], axis=1)

        out = np.zeros((len(raw_actions), 7))
        for idx, raw in enumerate(raw_actions):
            ax, angle = euler2axangle(*raw[3:6])
            gripper = self.postprocess_gripper(float(raw[-1]))
            out[idx] = np.concatenate([raw[:3], ax * angle, [gripper]])
        return out

    def preprocess_proprio(self, obs: dict) -> np.ndarray:
        raise NotImplementedError

    def postprocess_gripper(self, action: float) -> float:
        raise NotImplementedError

    def get_video_frame(self, env, obs: dict) -> np.ndarray:
        return _get_simpler_image(env, obs)


class BridgeSimplerAdapter(SimplerAdapter):
    """WidowX / bridge tasks (reference simpler.py:155-187)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        # Bridge EE pose is relative to a top-down pose, not the robot base
        self.default_rot = np.array([[0, 0, 1.0], [0, 1.0, 0], [-1.0, 0, 0]])

    def preprocess_proprio(self, obs: dict) -> np.ndarray:
        proprio = np.asarray(obs["agent"]["eef_pos"])
        rm_bridge = quat2mat(proprio[3:7])
        rpy = mat2euler(rm_bridge @ self.default_rot.T)
        return np.concatenate([proprio[:3], rpy, [proprio[7]]])

    def postprocess_gripper(self, action: float) -> float:
        # trained with [0, 1] (0 close, 1 open) -> simpler wants -1 close / 1 open
        return 2.0 * (action > 0.5) - 1.0


class EDRSimplerAdapter(SimplerAdapter):
    """Google-robot / fractal tasks with the sticky-gripper state machine
    (reference simpler.py:190-253; the 15-repeat constant comes from Octo's
    Simpler inference at 3 Hz control)."""

    STICKY_NUM_REPEAT = 15

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.reset()

    def reset(self):
        self.sticky_action_is_on = False
        self.gripper_action_repeat = 0
        self.sticky_gripper_action = 0.0
        super().reset()

    def preprocess_proprio(self, obs: dict) -> np.ndarray:
        eef = np.asarray(obs["agent"]["eef_pos"])
        quat_xyzw = np.roll(eef[3:7], -1)  # simpler gives wxyz; fractal uses xyzw
        gripper_closedness = 1.0 - eef[7]  # fractal proprio stores closedness
        return np.concatenate([eef[:3], quat_xyzw, [gripper_closedness]])

    def postprocess_gripper(self, action: float) -> float:
        # trained with [0, 1] (0 close, 1 open) -> simpler wants -1 open / 1 close
        action = action * 2.0 - 1.0
        relative = -action

        if abs(relative) > 0.5 and not self.sticky_action_is_on:
            self.sticky_action_is_on = True
            self.sticky_gripper_action = relative
        if self.sticky_action_is_on:
            self.gripper_action_repeat += 1
            relative = self.sticky_gripper_action
        if self.gripper_action_repeat == self.STICKY_NUM_REPEAT:
            self.sticky_action_is_on = False
            self.gripper_action_repeat = 0
            self.sticky_gripper_action = 0.0
        return relative


_ADAPTERS = {
    "bridge": BridgeSimplerAdapter,
    "edr": EDRSimplerAdapter,
    "fractal": EDRSimplerAdapter,
}


def make_adapter(name: str, **kwargs) -> SimplerAdapter:
    """Config-driven adapter factory (replaces the reference's hydra
    `_target_` instantiation, config/eval/bridge.yaml)."""
    try:
        cls = _ADAPTERS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown env adapter '{name}'; known: {sorted(_ADAPTERS)}")
    return cls(**kwargs)
