"""SimplerLite: a kinematic language-conditioned reach environment
(counterpart of the JAX package's ``envs/reach_env.py``, numpy only).

It speaks the protocol the reference's eval loop drives SimplerEnv with
(reference src/agent/eval.py:60-179):

  obs, info = env.reset(seed=..., options={"obj_init_options":
                                            {"episode_id": k}})
  obs, reward, success, truncated, info = env.step(action)
  env.get_language_instruction()

Task: two colored blocks at episode-keyed random positions; the
instruction ("reach the red block" / "reach the green block") picks the
target. Success requires BOTH vision (positions are only in the image)
and language (color selects which block). The policy command is the
simpler/WidowX format the bridge adapter emits: [dx, dy, dz,
axis-angle rotation (3), gripper] — the env integrates the xyz delta.

The demo writers (``collect_demos``, ``write_demo_dataset`` and the
``register_*`` training mixes) write RLDS through TensorFlow: they wait
with the data pipeline (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from open_pi_zero_torch.utils.geometry import mat2euler, quat2mat

# ---- geometry of the task (world units are meters-ish) ----
WORKSPACE = (-0.22, 0.22)  # square tabletop, both axes
BLOCK_RANGE = 0.15  # block centers within [-r, r]^2
BLOCK_HALF = 0.032  # half side of a block square (~7 px at the model's 56)
EEF_RADIUS = 0.024  # rendered end-effector disc
MAX_STEP = 0.03  # per-step |dx|,|dy| clamp (like Simpler's action scale)
SUCCESS_RADIUS = 0.05
MIN_BLOCK_SEP = 0.16  # keeps the two targets unambiguous (> 2*SUCCESS_RADIUS)
MIN_START_DIST = 0.09  # no episode starts already solved
EEF_Z = 0.05

COLORS = {"red": (230, 25, 25), "green": (25, 200, 35)}
INSTRUCTIONS = tuple(f"reach the {c} block" for c in COLORS)  # fixed order

# Constant eef orientation: rotation of +90 deg about y, whose matrix IS the
# bridge adapter's `default_rot` — so the adapter's bridge-frame rpy
# (mat2euler(R @ default_rot.T), env_adapter.py:163-167) is exactly (0,0,0).
EEF_QUAT_WXYZ = np.array([np.sqrt(0.5), 0.0, np.sqrt(0.5), 0.0])
_BRIDGE_DEFAULT_ROT = np.array([[0, 0, 1.0], [0, 1.0, 0], [-1.0, 0, 0]])


def bridge_proprio(obs: dict) -> np.ndarray:
    """obs -> the 7d bridge proprio [xyz, rpy, gripper] — the same formula
    BridgeSimplerAdapter.preprocess_proprio applies at eval time
    (env_adapter.py:163-167), used here to record the demo `state` so
    train-time proprio == eval-time proprio."""
    p = np.asarray(obs["agent"]["eef_pos"], np.float64)
    rpy = mat2euler(quat2mat(p[3:7]) @ _BRIDGE_DEFAULT_ROT.T)
    return np.concatenate([p[:3], rpy, [p[7]]]).astype(np.float32)


class ReachEnv:
    """Kinematic two-block reach task with episode-keyed placement."""

    def __init__(
        self,
        seed: int = 0,
        render_size: int = 112,
        max_steps: int = 60,
        multi_subtask: bool = False,
    ):
        """multi_subtask: after the instructed block is reached the
        instruction SWITCHES to the other color mid-episode (the reference's
        multi-task envs do this, reference src/agent/eval.py:137-142);
        success requires completing both legs. Exercises the eval loop's
        instruction re-tokenization and the policy's per-chunk language
        conditioning."""
        self.base_seed = int(seed)
        self.render_size = int(render_size)
        self.max_steps = int(max_steps)
        self.multi_subtask = bool(multi_subtask)
        # pixel-center world coordinates, cached for rendering masks
        lo, hi = WORKSPACE
        centers = lo + (np.arange(self.render_size) + 0.5) * (hi - lo) / self.render_size
        self._px_x = centers[None, :]  # image column -> world x
        self._px_y = centers[:, None]  # image row    -> world y
        self.reset(seed=seed)

    # ------------------------------------------------------------------ #
    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self.base_seed = int(seed)
        episode_id = int(
            ((options or {}).get("obj_init_options") or {}).get("episode_id", 0)
        )
        rng = np.random.default_rng((self.base_seed, episode_id))
        self.eef = rng.uniform(-0.05, 0.05, size=2)
        while True:
            blocks = rng.uniform(-BLOCK_RANGE, BLOCK_RANGE, size=(2, 2))
            if (
                np.linalg.norm(blocks[0] - blocks[1]) >= MIN_BLOCK_SEP
                and np.linalg.norm(blocks - self.eef, axis=1).min() >= MIN_START_DIST
            ):
                break
        self.blocks = blocks  # row i is COLORS order: 0=red, 1=green
        self.target_idx = int(rng.integers(2))
        self.instruction = INSTRUCTIONS[self.target_idx]
        self.t = 0
        self._phase = 0
        self._success = False
        return self._obs(), {}

    def get_language_instruction(self) -> str:
        return self.instruction

    @property
    def target_xy(self) -> np.ndarray:
        return self.blocks[self.target_idx]

    def step(self, action: np.ndarray):
        """action: simpler command [dx, dy, dz, axangle(3), gripper]; only
        the xy delta moves the (planar) end effector."""
        action = np.asarray(action, np.float64).reshape(-1)
        delta = np.clip(action[:2], -MAX_STEP, MAX_STEP)
        lo, hi = WORKSPACE
        self.eef = np.clip(self.eef + delta, lo, hi)
        self.t += 1
        reached = np.linalg.norm(self.eef - self.target_xy) < SUCCESS_RADIUS
        if reached and self.multi_subtask and self._phase == 0:
            # leg 1 done: switch the instruction to the other block; overall
            # success is only latched when the second leg completes
            self._phase = 1
            self.target_idx = 1 - self.target_idx
            self.instruction = INSTRUCTIONS[self.target_idx]
        elif reached:
            self._success = True  # latched, like Simpler
        truncated = self.t >= self.max_steps
        return self._obs(), float(reached), self._success, truncated, {}

    # ------------------------------------------------------------------ #
    def _obs(self) -> dict:
        eef_pos = np.concatenate(
            [self.eef, [EEF_Z], EEF_QUAT_WXYZ, [0.5]]
        ).astype(np.float64)
        return {"agent": {"eef_pos": eef_pos}, "image": self.render()}

    def get_image(self, obs: dict) -> np.ndarray:
        """Image hook for env_adapter._get_simpler_image (in-repo envs carry
        the frame in the obs dict instead of a maniskill camera tree)."""
        return obs["image"]

    def render(self) -> np.ndarray:
        img = np.full((self.render_size, self.render_size, 3), 214, np.uint8)
        for (bx, by), color in zip(self.blocks, COLORS.values()):
            mask = (np.abs(self._px_x - bx) <= BLOCK_HALF) & (
                np.abs(self._px_y - by) <= BLOCK_HALF
            )
            img[mask] = color
        eef_mask = (self._px_x - self.eef[0]) ** 2 + (
            self._px_y - self.eef[1]
        ) ** 2 <= EEF_RADIUS**2
        img[eef_mask] = (30, 60, 200)
        return img


# --------------------------------------------------------------------------- #
# scripted expert
# --------------------------------------------------------------------------- #


def scripted_expert(env: ReachEnv, rng: np.random.Generator, noise: float = 0.004):
    """Oracle P-controller in raw command space: clipped step toward the
    target plus exploration noise; rotation zero, gripper held open (1.0,
    the bridge convention the pipeline binarizes)."""
    delta = np.clip(env.target_xy - env.eef, -MAX_STEP, MAX_STEP)
    delta = delta + rng.normal(0.0, noise, size=2)
    return np.concatenate([delta, [0.0, 0.0, 0.0, 0.0], [1.0]]).astype(np.float32)


def warm_tokenizer(tokenizer) -> None:
    """Assign word ids for every instruction in the fixed INSTRUCTIONS order.
    ``processing.FakeTokenizer`` hands out ids in first-seen order;
    warming both the train-side and eval-side tokenizers makes their
    vocabularies identical regardless of data-shuffle order."""
    from open_pi_zero_torch.envs.drawer_env import INSTRUCTIONS as DRAWER_INSTRUCTIONS
    from open_pi_zero_torch.envs.pick_place_env import INSTRUCTION as PP_INSTRUCTION
    from open_pi_zero_torch.processing import IMAGE_TOKEN

    # _encode needs the image special token registered (the processor
    # normally does this); registering twice is a no-op
    tokenizer.add_special_tokens({"additional_special_tokens": [IMAGE_TOKEN]})
    for s in (*INSTRUCTIONS, PP_INSTRUCTION, *DRAWER_INSTRUCTIONS):
        tokenizer._encode(s)
