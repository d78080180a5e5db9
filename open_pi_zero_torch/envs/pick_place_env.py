"""SimplerLite pick-and-place: a kinematic grasp-carry-release task
(counterpart of the JAX package's ``envs/pick_place_env.py``, numpy only).

Second task family beside the reach env (reach_env.py): the policy must
CLOSE the gripper near the block, carry it to the zone, and OPEN to
release — so the gripper action dim is informative (the reach task holds
it constant), exercising in a learned closed loop the whole gripper
chain: expert {0,1} commands -> binarize_gripper_actions in the bridge
standardization (data/oxe.py:41-53) -> flow-matching regression ->
BridgeSimplerAdapter.postprocess_gripper threshold (+1 open / -1 close,
env_adapter.py:169-171) -> attachment dynamics here. Same protocol as
ReachEnv (reference src/agent/eval.py:60-179).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from open_pi_zero_torch.envs.reach_env import (
    BLOCK_HALF,
    EEF_QUAT_WXYZ,
    EEF_RADIUS,
    EEF_Z,
    MAX_STEP,
    MIN_START_DIST,
    WORKSPACE,
)

GRASP_RADIUS = 0.05  # closed within this of the block -> attached
ZONE_RADIUS = 0.055  # release within this of the zone center -> success
MIN_BLOCK_ZONE_SEP = 0.18  # a carry is always required
PP_RANGE = 0.15  # block/zone centers within [-r, r]^2

BLOCK_COLOR = (230, 25, 25)
ZONE_COLOR = (185, 228, 185)  # pale green pad, visually distinct from blocks
INSTRUCTION = "put the red block in the green zone"


class PickPlaceEnv:
    """Kinematic grasp/carry/release with episode-keyed placement."""

    def __init__(self, seed: int = 0, render_size: int = 112, max_steps: int = 96):
        self.base_seed = int(seed)
        self.render_size = int(render_size)
        self.max_steps = int(max_steps)
        lo, hi = WORKSPACE
        centers = lo + (np.arange(self.render_size) + 0.5) * (hi - lo) / self.render_size
        self._px_x = centers[None, :]
        self._px_y = centers[:, None]
        self.reset(seed=seed)

    # ------------------------------------------------------------------ #
    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self.base_seed = int(seed)
        episode_id = int(
            ((options or {}).get("obj_init_options") or {}).get("episode_id", 0)
        )
        rng = np.random.default_rng((self.base_seed, 17, episode_id))
        self.eef = rng.uniform(-0.05, 0.05, size=2)
        while True:
            self.block = rng.uniform(-PP_RANGE, PP_RANGE, size=2)
            self.zone = rng.uniform(-PP_RANGE, PP_RANGE, size=2)
            if (
                np.linalg.norm(self.block - self.zone) >= MIN_BLOCK_ZONE_SEP
                and np.linalg.norm(self.block - self.eef) >= MIN_START_DIST
            ):
                break
        self.gripper_open = True
        self.attached = False
        self.t = 0
        self._success = False
        return self._obs(), {}

    def get_language_instruction(self) -> str:
        return INSTRUCTION

    def step(self, action: np.ndarray):
        """action: simpler command [dx, dy, dz, axangle(3), gripper] with
        gripper +1 open / -1 close (the bridge adapter's output
        convention)."""
        action = np.asarray(action, np.float64).reshape(-1)
        delta = np.clip(action[:2], -MAX_STEP, MAX_STEP)
        lo, hi = WORKSPACE
        self.eef = np.clip(self.eef + delta, lo, hi)
        close_cmd = action[6] < 0.0

        self.gripper_open = not close_cmd
        if self.attached and self.gripper_open:
            self.attached = False
            if np.linalg.norm(self.block - self.zone) < ZONE_RADIUS:
                self._success = True  # released in the zone — latched
        if (
            not self.gripper_open
            and not self.attached
            and np.linalg.norm(self.eef - self.block) < GRASP_RADIUS
        ):
            # continuous ("magnetic") attach: any closed step near the block
            # grasps — an open->close EDGE exactly inside the radius is an
            # unlearnable timing constraint under 4-step open-loop chunks
            # (measured: 12/12 episodes close the gripper, 3/12 attach)
            self.attached = True
        if self.attached:
            self.block = self.eef.copy()

        self.t += 1
        truncated = self.t >= self.max_steps
        reward = float(self._success)
        return self._obs(), reward, self._success, truncated, {}

    # ------------------------------------------------------------------ #
    def _obs(self) -> dict:
        eef_pos = np.concatenate(
            [self.eef, [EEF_Z], EEF_QUAT_WXYZ, [1.0 if self.gripper_open else 0.0]]
        ).astype(np.float64)
        return {"agent": {"eef_pos": eef_pos}, "image": self.render()}

    def get_image(self, obs: dict) -> np.ndarray:
        return obs["image"]

    def render(self) -> np.ndarray:
        img = np.full((self.render_size, self.render_size, 3), 214, np.uint8)
        zx, zy = self.zone
        zone_mask = (np.abs(self._px_x - zx) <= 1.6 * BLOCK_HALF) & (
            np.abs(self._px_y - zy) <= 1.6 * BLOCK_HALF
        )
        img[zone_mask] = ZONE_COLOR
        bx, by = self.block
        block_mask = (np.abs(self._px_x - bx) <= BLOCK_HALF) & (
            np.abs(self._px_y - by) <= BLOCK_HALF
        )
        img[block_mask] = BLOCK_COLOR
        r = EEF_RADIUS if self.gripper_open else 0.6 * EEF_RADIUS
        eef_mask = (self._px_x - self.eef[0]) ** 2 + (
            self._px_y - self.eef[1]
        ) ** 2 <= r**2
        img[eef_mask] = (30, 60, 200)  # smaller disc when closed: visible state
        return img


# --------------------------------------------------------------------------- #
# scripted expert (RAW dataset convention: gripper 1.0 open / 0.0 closed —
# what the bridge pipeline binarizes and the adapter re-thresholds)
# --------------------------------------------------------------------------- #


def pick_place_expert(
    env: PickPlaceEnv, rng: np.random.Generator, noise: float = 0.003
) -> np.ndarray:
    if env._success:
        # task done: hold position with the gripper open (the post-success
        # frames kept by collect_demos teach "stay put", not "re-grasp")
        move, grip = np.zeros(2), 1.0
        delta = np.clip(move, -MAX_STEP, MAX_STEP) + rng.normal(0.0, noise, size=2)
        return np.concatenate([delta, [0.0, 0.0, 0.0, 0.0], [grip]]).astype(
            np.float32
        )
    if not env.attached:
        to_block = env.block - env.eef
        if np.linalg.norm(to_block) > 0.55 * GRASP_RADIUS:
            move, grip = to_block, 1.0  # approach, open
        else:
            move, grip = np.zeros(2), 0.0  # hover and close
        if not env.gripper_open and np.linalg.norm(to_block) > GRASP_RADIUS:
            grip = 1.0  # missed grasp: reopen and retry
    else:
        to_zone = env.zone - env.eef
        if np.linalg.norm(to_zone) > 0.45 * ZONE_RADIUS:
            move, grip = to_zone, 0.0  # carry, stay closed
        else:
            move, grip = np.zeros(2), 1.0  # release
    delta = np.clip(move, -MAX_STEP, MAX_STEP) + rng.normal(0.0, noise, size=2)
    return np.concatenate([delta, [0.0, 0.0, 0.0, 0.0], [grip]]).astype(np.float32)
