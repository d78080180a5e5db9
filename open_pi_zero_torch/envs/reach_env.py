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

The demo writers (``collect_demos``, ``write_demo_dataset``) roll the
scripted expert and write its episodes as RLDS through the port's own
writer (``data/rlds.py``), frames JPEG-encoded by the port's own codec
(``data/jpeg.py``) at ``tf.io.encode_jpeg``'s defaults, byte for byte the
JAX package's. The ``register_*``
functions add the SimplerLite training mixes to ``data/oxe.py``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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
# scripted expert + demo collection
# --------------------------------------------------------------------------- #


def scripted_expert(env: ReachEnv, rng: np.random.Generator, noise: float = 0.004):
    """Oracle P-controller in raw command space: clipped step toward the
    target plus exploration noise; rotation zero, gripper held open (1.0,
    the bridge convention the pipeline binarizes)."""
    delta = np.clip(env.target_xy - env.eef, -MAX_STEP, MAX_STEP)
    delta = delta + rng.normal(0.0, noise, size=2)
    return np.concatenate([delta, [0.0, 0.0, 0.0, 0.0], [1.0]]).astype(np.float32)


def collect_demos(
    n_episodes: int,
    seed: int = 0,
    render_size: int = 112,
    hold_steps: int = 4,
    max_steps: Optional[int] = None,
    task: str = "reach",
) -> Tuple[List[dict], float]:
    """Roll the task's expert; returns (episodes in the bridge_dataset RLDS
    step schema, frames JPEG-encoded; expert success rate). Each episode
    keeps `hold_steps` stay-put frames after first success so the policy
    also learns to hold position (keeps success latched under closed-loop
    chunked control).

    Expert actions are recorded in the RAW bridge dataset convention
    (gripper 1.0 open / 0.0 closed); the env is stepped with the SAME
    conversion the adapter applies at eval time (gripper binarize ->
    +1/-1, env_adapter.py:200-203), so demo dynamics match eval dynamics."""
    from open_pi_zero_torch.data.jpeg import encode_jpeg
    from open_pi_zero_torch.envs import TASKS

    spec = TASKS[task]
    env = spec["env"](
        seed=seed,
        render_size=render_size,
        max_steps=int(max_steps or spec["max_steps"]),
    )
    expert = spec["expert"]
    episodes, successes = [], []
    for ep_id in range(n_episodes):
        obs, _ = env.reset(options={"obj_init_options": {"episode_id": ep_id}})
        rng = np.random.default_rng((seed, ep_id, 7))
        images, states, actions = [], [], []
        reached_at = None
        while True:
            act = expert(env, rng)
            images.append(encode_jpeg(obs["image"]))
            states.append(bridge_proprio(obs))
            actions.append(act)
            cmd = np.concatenate([act[:6], [2.0 * (act[6] > 0.5) - 1.0]])
            obs, _, success, truncated, _ = env.step(cmd)
            if success and reached_at is None:
                reached_at = env.t
            done = truncated or (reached_at is not None and env.t >= reached_at + hold_steps)
            if done:
                # closing frame so relabel_actions_from_proprio (which drops
                # the last step, data/oxe.py) keeps every real action
                images.append(encode_jpeg(obs["image"]))
                states.append(bridge_proprio(obs))
                actions.append(act)
                break
        successes.append(bool(success))
        episodes.append(
            {
                "steps": {
                    "observation": {
                        "image_0": images,
                        "state": np.stack(states),
                    },
                    "action": np.stack(actions),
                    "language_instruction": [env.get_language_instruction().encode()]
                    * len(images),
                },
                "episode_metadata": {"file_path": f"/sim/ep{ep_id}".encode()},
            }
        )
    return episodes, float(np.mean(successes))


def write_demo_dataset(
    data_dir: str,
    n_episodes: int,
    seed: int = 0,
    render_size: int = 112,
    shards: int = 4,
    max_steps: Optional[int] = None,
    task: str = "reach",
    dataset_name: str = "bridge_dataset",
) -> float:
    """Collect expert demos and write them as a `bridge_dataset` RLDS dir
    (TFRecord shards + features.json + dataset_info.json) in the layout the
    bridge pipeline reads, so training uses the UNMODIFIED registry entry
    and standardization transform. Returns the expert success rate."""
    from open_pi_zero_torch.data import rlds

    episodes, expert_rate = collect_demos(
        n_episodes, seed=seed, render_size=render_size, max_steps=max_steps,
        task=task,
    )
    leaves = [
        rlds.LeafSpec(
            "steps/observation/image_0", "uint8",
            (render_size, render_size, 3), "image", True, "jpeg",
        ),
        rlds.LeafSpec("steps/observation/state", "float32", (7,), "tensor", True),
        rlds.LeafSpec("steps/action", "float32", (7,), "tensor", True),
        rlds.LeafSpec("steps/language_instruction", "string", (), "text", True),
        rlds.LeafSpec("episode_metadata/file_path", "string", (), "text", False),
    ]
    rlds.write_rlds_dataset(
        data_dir, dataset_name, episodes, leaves, shards=min(shards, n_episodes)
    )
    return expert_rate


def register_simpler_lite_mix() -> str:
    """Register a two-dataset mix for multi-task training: reach demos
    under the stock `bridge_dataset` entry plus pick-place demos under a
    runtime `simpler_lite_pp` entry (same schema/transform as bridge).
    Exercises the interleaved multi-dataset path — weighted sampling with
    transition-count weight balancing, per-dataset statistics — the way
    the reference trains on OXE mixes (reference
    src/data/dataset.py:583-640). Returns the mix name."""
    from open_pi_zero_torch.data import oxe

    if "simpler_lite_pp" not in oxe.REGISTRY:
        oxe.REGISTRY["simpler_lite_pp"] = {
            "image_obs_keys": {"primary": "image_0", "secondary": None, "wrist": None},
            "depth_obs_keys": {"primary": None, "secondary": None, "wrist": None},
            "proprio_encoding": oxe.ProprioEncoding.POS_EULER,
            "action_encoding": oxe.ActionEncoding.EEF_POS,
        }
        oxe.STANDARDIZE_FNS["simpler_lite_pp"] = oxe.bridge_transform
        oxe.MIXES["simpler_lite_multi"] = [
            ("bridge_dataset", 1.0),
            ("simpler_lite_pp", 1.0),
        ]
    return "simpler_lite_multi"


def register_simpler_lite_tri_mix() -> str:
    """Three-task CROSS-FAMILY mix: bridge reach + bridge pick-place (both
    7-dim POS_EULER) + fractal drawer (8-dim POS_QUAT, raw RT-1 schema
    through the stock rt1_transform). One policy over heterogeneous
    proprio widths and both env-adapter families — the shape of the
    reference's real OXE mixes, where bridge and fractal coexist in one
    training stream. Returns the mix name."""
    from open_pi_zero_torch.data import oxe

    register_simpler_lite_mix()  # ensures simpler_lite_pp exists
    if "simpler_lite_tri" not in oxe.MIXES:
        oxe.MIXES["simpler_lite_tri"] = [
            ("bridge_dataset", 1.0),
            ("simpler_lite_pp", 1.0),
            ("fractal20220817_data", 1.0),
        ]
    return "simpler_lite_tri"


def register_simpler_lite_tri_lever_mix(cov_weight: float = 0.5) -> str:
    """Tri-family mix with the drawer language-grounding lever: the three
    cross-family datasets of register_simpler_lite_tri_mix plus the
    coverage-start drawer secondary at reduced weight (the drawer primary
    is collected no-coverage + per-target balanced by the caller — see
    drawer_env.register_drawer_lever_mix)."""
    from open_pi_zero_torch.data import oxe
    from open_pi_zero_torch.envs.drawer_env import register_drawer_lever_mix

    register_simpler_lite_mix()
    register_drawer_lever_mix(cov_weight)
    if "simpler_lite_tri_lever" not in oxe.MIXES:
        oxe.MIXES["simpler_lite_tri_lever"] = [
            ("bridge_dataset", 1.0),
            ("simpler_lite_pp", 1.0),
            ("fractal20220817_data", 1.0),
            ("fractal_drawer_cov", float(cov_weight)),
        ]
    return "simpler_lite_tri_lever"


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
