"""SimplerLite drawer task: the fractal/EDR (google-robot) family
(counterpart of the JAX package's ``envs/drawer_env.py``, numpy only).

Third SimplerLite task, and the first in the FRACTAL family: demos are
written in the raw fractal20220817_data schema (nested action dict with
world_vector / rotation_delta / relative gripper_closedness_action;
observation carries base_pose_tool_reached + gripper_closed +
natural_language_instruction), flow through the UNMODIFIED rt1_transform
(rel2abs gripper, POS_QUAT proprio; reference
oxe_standardization_transforms.py:43-68), and eval runs through the real
EDRSimplerAdapter — including the 15-step STICKY gripper state machine
(reference simpler.py:190-253) — so the google-robot half of the
reference's eval stack is exercised in a *learned* closed loop, not just
by state-machine goldens.

Task (mirrors Simpler's "open the {top,middle,bottom} drawer"): a cabinet
with three stacked drawers at an episode-keyed position; the instruction
picks which drawer. The policy must approach that drawer's handle with
the gripper open, close on it (continuous closedness dynamics — the
relative gripper command integrates, like the real google robot's 3 Hz
gripper), and pull along +x past the success extension. Success requires
vision (cabinet position only in pixels) AND language (instruction picks
the drawer) AND gripper control (no grasp, no pull).

The demo writers (``collect_fractal_demos``, ``write_fractal_demo_dataset``)
write the raw fractal schema through the port's RLDS writer, frames in
JPEG as ``reach_env.write_demo_dataset`` writes them;
``register_drawer_lever_mix`` adds the lever mix to ``data/oxe.py``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from open_pi_zero_torch.envs.reach_env import EEF_QUAT_WXYZ, EEF_Z, MAX_STEP, WORKSPACE

# ---- cabinet geometry (world units, same planar tabletop as reach) ----
CABINET_HALF_W = 0.050  # x half-width of the closed cabinet body
CABINET_HALF_H = 0.160  # y half-height of the body
PANEL_HALF_H = 0.038  # y half-height of one drawer front panel
PANEL_THICK = 0.018  # x thickness of the front panel
DRAWER_DY = 0.105  # vertical spacing between drawer centers
HANDLE_OFF = 0.012  # handle protrusion beyond the front panel
HANDLE_HALF = 0.013  # rendered handle half-size
D_MAX = 0.080  # full drawer travel
SUCCESS_EXT = 0.055  # instructed drawer counts as open past this
GRASP_RADIUS = 0.05
# Closedness change per unit relative command per step. Deliberately SLOW
# (6 steps to grasp threshold): the google robot's gripper actuates over
# ~a second at 3 Hz control, which is exactly why the reference's EDR
# adapter carries the 15-step sticky repeat machine (simpler.py:190-253,
# "the 15-repeat constant comes from Octo's Simpler inference at 3 Hz").
# A slow env gripper makes the demos contain many "commanding close while
# still open" frames, so the sticky machine's trigger delays at eval stay
# in-distribution for the learned policy.
GRIP_RATE = 0.125
CLOSE_THRESH = 0.75  # closedness needed to grasp the handle
OPEN_THRESH = 0.5  # dropping below this releases the handle

NAMES = ("top", "middle", "bottom")
INSTRUCTIONS = tuple(f"open the {n} drawer" for n in NAMES)

BODY_COLOR = (96, 92, 90)
PANEL_COLOR = (176, 170, 164)
INTERIOR_COLOR = (60, 48, 40)  # exposed drawer box once pulled out
HANDLE_COLOR = (35, 30, 28)


class DrawerEnv:
    """Kinematic three-drawer cabinet with episode-keyed placement.

    Protocol identical to the other SimplerLite envs (reference
    src/agent/eval.py:60-179): reset(seed, options={"obj_init_options":
    {"episode_id": k}}) / step / get_language_instruction. Commands are
    the EDR adapter's output format [dx, dy, dz, axis-angle (3),
    gripper_relative] with gripper_relative > 0 closing (the sticky
    machine's convention, env_adapter.py:226-241); the env integrates
    closedness at GRIP_RATE per step like the google robot's continuous
    gripper.
    """

    def __init__(self, seed: int = 0, render_size: int = 112, max_steps: int = 112,
                 target: Optional[str] = None):
        self.base_seed = int(seed)
        self.render_size = int(render_size)
        self.max_steps = int(max_steps)
        # Optional single-target restriction ("top"/"middle"/"bottom") for
        # per-target data-efficiency experiments. The unrestricted target
        # draw still happens at reset so cabinet/eef layouts for a given
        # episode_id are IDENTICAL to the 3-target env.
        if target is not None and target not in NAMES:
            raise ValueError(f"unknown drawer target {target!r}; known: {NAMES}")
        self._fixed_target = None if target is None else NAMES.index(target)
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
        rng = np.random.default_rng((self.base_seed, 31, episode_id))
        self.cab = np.array(
            [rng.uniform(-0.16, -0.10), rng.uniform(-0.035, 0.035)]
        )
        self.ext = np.zeros(3)  # per-drawer extension in [0, D_MAX]
        self.target_idx = int(rng.integers(3))
        if self._fixed_target is not None:
            self.target_idx = self._fixed_target
        self.instruction = INSTRUCTIONS[self.target_idx]
        self.eef = np.array([rng.uniform(0.08, 0.17), rng.uniform(-0.12, 0.12)])
        self.closedness = 0.0
        self.attached: Optional[int] = None  # drawer index while grasped
        self.t = 0
        self._success = False
        return self._obs(), {}

    def get_language_instruction(self) -> str:
        return self.instruction

    def randomize_start(self, rng: np.random.Generator) -> dict:
        """Redraw the eef start uniformly over the FULL workspace (demo
        collection only — eval keeps the episode-keyed start). The default
        start band (y in [-0.12, 0.12]) lies mostly BELOW the bottom
        handle (y in [0.07, 0.14]), so bottom-target demos almost never
        contain corrective -y approaches; a policy that open-loop replays
        the mean demo (race +y, close on schedule) fits that data nearly
        as well as a servoing one and fails closed-loop. Full-workspace
        starts put states above/beside every handle into the demos, which
        decorrelates approach duration from close timing and forces
        state-conditioned behavior. Starts are rejection-sampled outside
        the cabinet body rectangle and outside every handle's grasp radius
        so coverage demos stay physically plausible (the kinematic env
        would otherwise allow pass-through starts a real sim forbids).
        Returns the refreshed obs."""
        lo, hi = WORKSPACE
        x0 = self.cab[0] - CABINET_HALF_W
        x1 = self.cab[0] + CABINET_HALF_W + PANEL_THICK
        y0 = self.cab[1] - CABINET_HALF_H
        y1 = self.cab[1] + CABINET_HALF_H
        for _ in range(100):
            eef = rng.uniform(lo + 0.01, hi - 0.01, size=2)
            in_cabinet = (x0 <= eef[0] <= x1) and (y0 <= eef[1] <= y1)
            near_handle = any(
                np.linalg.norm(self.handle_pos(i) - eef) < GRASP_RADIUS
                for i in range(3)
            )
            if not in_cabinet and not near_handle:
                break
        self.eef = eef
        return self._obs()

    def handle_pos(self, i: int) -> np.ndarray:
        """World xy of drawer i's handle center."""
        x = self.cab[0] + CABINET_HALF_W + self.ext[i] + HANDLE_OFF
        y = self.cab[1] + (i - 1) * DRAWER_DY
        return np.array([x, y])

    def step(self, action: np.ndarray):
        """action: EDR command [dx, dy, dz, axangle(3), gripper_relative]."""
        action = np.asarray(action, np.float64).reshape(-1)
        delta = np.clip(action[:2], -MAX_STEP, MAX_STEP)
        rel = float(np.clip(action[6], -1.0, 1.0))
        self.closedness = float(np.clip(self.closedness + GRIP_RATE * rel, 0.0, 1.0))

        if self.attached is not None and self.closedness < OPEN_THRESH:
            self.attached = None  # released the handle; drawer stays put
        if self.attached is None:
            lo, hi = WORKSPACE
            self.eef = np.clip(self.eef + delta, lo, hi)
            if self.closedness >= CLOSE_THRESH:
                dists = [np.linalg.norm(self.handle_pos(i) - self.eef) for i in range(3)]
                i = int(np.argmin(dists))
                if dists[i] < GRASP_RADIUS:
                    self.attached = i
                    self.eef = self.handle_pos(i)
        else:
            # grasped: motion is constrained to the drawer rail (x only)
            i = self.attached
            self.ext[i] = float(np.clip(self.ext[i] + delta[0], 0.0, D_MAX))
            self.eef = self.handle_pos(i)

        if self.ext[self.target_idx] >= SUCCESS_EXT:
            self._success = True  # latched, like Simpler's drawer qpos check
        self.t += 1
        truncated = self.t >= self.max_steps
        return self._obs(), float(self._success), self._success, truncated, {}

    # ------------------------------------------------------------------ #
    def _obs(self) -> dict:
        # eef_pos layout matches the other SimplerLite envs: [xyz, quat wxyz,
        # OPENNESS]; EDRSimplerAdapter derives closedness = 1 - eef[7]
        # (env_adapter.py:220-224)
        eef_pos = np.concatenate(
            [self.eef, [EEF_Z], EEF_QUAT_WXYZ, [1.0 - self.closedness]]
        ).astype(np.float64)
        return {"agent": {"eef_pos": eef_pos}, "image": self.render()}

    def get_image(self, obs: dict) -> np.ndarray:
        return obs["image"]

    def _rect(self, x0, x1, y0, y1) -> np.ndarray:
        return (
            (self._px_x >= x0) & (self._px_x <= x1)
            & (self._px_y >= y0) & (self._px_y <= y1)
        )

    def render(self) -> np.ndarray:
        img = np.full((self.render_size, self.render_size, 3), 214, np.uint8)
        cx, cy = self.cab
        img[
            self._rect(cx - CABINET_HALF_W, cx + CABINET_HALF_W,
                       cy - CABINET_HALF_H, cy + CABINET_HALF_H)
        ] = BODY_COLOR
        for i in range(3):
            y = cy + (i - 1) * DRAWER_DY
            face = cx + CABINET_HALF_W + self.ext[i]
            if self.ext[i] > 1e-6:  # exposed drawer box behind the panel
                img[
                    self._rect(cx + CABINET_HALF_W, face - PANEL_THICK,
                               y - PANEL_HALF_H, y + PANEL_HALF_H)
                ] = INTERIOR_COLOR
            img[
                self._rect(face - PANEL_THICK, face,
                           y - PANEL_HALF_H, y + PANEL_HALF_H)
            ] = PANEL_COLOR
            hx, hy = face + HANDLE_OFF, y
            img[
                self._rect(hx - HANDLE_HALF, hx + HANDLE_HALF,
                           hy - HANDLE_HALF, hy + HANDLE_HALF)
            ] = HANDLE_COLOR
        # eef disc shrinks as the gripper closes (visible gripper state);
        # GRASP state is rendered as a color change — in the real Simpler
        # renderer attachment is visually unambiguous (the fingers wrap the
        # handle); a minimal disc that hides it forces the policy to
        # discriminate a ~2 px at-handle-vs-near-handle gap at 56x56, and
        # five traced training runs showed the regression collapsing to a
        # servo field with velocity ~0 exactly at the handle (the pull
        # never forms; docs/DRAWER_INVESTIGATION.md)
        r = (0.024 - 0.010 * self.closedness)
        eef_mask = (self._px_x - self.eef[0]) ** 2 + (
            self._px_y - self.eef[1]
        ) ** 2 <= r**2
        img[eef_mask] = (30, 200, 60) if self.attached is not None else (30, 60, 200)
        return img


# --------------------------------------------------------------------------- #
# scripted expert — RAW fractal convention: gripper_closedness_action is a
# RELATIVE command (+1 closing, -1 opening, 0 hold), exactly what
# rel2abs_gripper_actions standardizes into absolute openness
# (data/oxe.py:56-70; reference data_utils.py:303-400)
# --------------------------------------------------------------------------- #


def drawer_expert(
    env: DrawerEnv, rng: np.random.Generator, noise: float = 0.003,
    close_dist: float = 2.0 * GRASP_RADIUS,
) -> np.ndarray:
    """Scripted demo policy. Three choices are EVAL-DISTRIBUTION-critical
    (each found by tracing a distinct closed-loop failure mode, round 4):

    - keep SQUEEZING (+1) through the pull and the post-success hold: the
      eval-side sticky machine (env_adapter.py:236-251) repeats the close
      command for 15 steps, driving closedness to 1.0 — an expert that
      holds (0.0) after the 0.75 attach threshold caps demo closedness at
      0.75, so every attached eval state sits OUTSIDE the demo proprio
      range and the policy freezes at the handle.
    - pull at 0.55x MAX_STEP: success needs only SUCCESS_EXT/MAX_STEP ~= 2
      full-speed steps, so attached frames were ~2 pulls vs 4 zero-action
      hold frames with near-identical observations — the flow regression
      averaged dx toward 0. A slower pull makes pull frames the majority
      of the attached phase.
    - `close_dist` = the DETERMINISTIC distance at which closing starts;
      within it the expert keeps approaching at reduced speed while
      squeezing, so closedness reaches ~1.0 by arrival. Two failed
      alternatives, both measured closed-loop:
        * a tight threshold (0.55x grasp radius) makes demo closedness a
          perfect phase clock; at eval ONE early close command is
          amplified by the sticky machine into closedness 1.0 during the
          approach — attached states pair closedness 1.0 with ext 0,
          which phase-locked demos never contain, and the pull signal
          dilutes into the stop/hold regime (5%/40);
        * RANDOMIZING close_dist per episode covers those states but
          makes the gripper label at a given distance irreducibly
          bimodal (open in tight episodes, closed in early ones); the
          regression collapses to the mean, which sits BELOW the sticky
          machine's |relative| > 0.5 trigger — the eval gripper never
          actuates at all (0/40 on every target, closedness 0.00 for
          whole episodes).
      The fix needs BOTH properties at once: gripper command a
      consistent function of the visible state (no mode averaging) AND
      closed-at-handle states in the demos — i.e. close early,
      deterministically, and slow the approach so the squeeze completes
      before arrival (the state trajectory the eval-side sticky machine
      produces)."""
    handle = env.handle_pos(env.target_idx)
    d = float(np.linalg.norm(handle - env.eef))
    if env._success:
        move, grip = np.zeros(2), 1.0  # done: hold position, keep squeezing
    elif env.attached == env.target_idx:
        move, grip = np.array([0.55 * MAX_STEP, 0.0]), 1.0  # pull, squeezing
    elif env.attached is not None:
        # grabbed a NON-target handle en route (possible when approaching
        # closed): release and re-approach — also the recovery behavior a
        # closed-loop policy needs when the sticky machine closes early
        move, grip = np.zeros(2), -1.0
    elif d <= close_dist:
        # approach slowly while squeezing: closedness ~1.0 on arrival
        move = np.clip(handle - env.eef, -0.4 * MAX_STEP, 0.4 * MAX_STEP)
        grip = 1.0
    else:
        move = handle - env.eef  # approach, gripper open
        grip = -1.0 if env.closedness > 0.25 else 0.0  # reopen after a miss
    delta = np.clip(move, -MAX_STEP, MAX_STEP) + rng.normal(0.0, noise, size=2)
    return np.concatenate([delta, [0.0, 0.0, 0.0, 0.0], [grip]]).astype(np.float32)


# --------------------------------------------------------------------------- #
# demo collection in the raw fractal20220817_data RLDS schema
# --------------------------------------------------------------------------- #


def fractal_proprio_parts(obs: dict) -> Tuple[np.ndarray, np.ndarray]:
    """obs -> (base_pose_tool_reached [7] = xyz + quat xyzw, gripper_closed
    [1]). rt1_transform concatenates these into the 8-dim POS_QUAT proprio —
    the same numbers EDRSimplerAdapter.preprocess_proprio computes at eval
    time (env_adapter.py:220-224), so train proprio == eval proprio."""
    p = np.asarray(obs["agent"]["eef_pos"], np.float64)
    quat_xyzw = np.roll(p[3:7], -1)  # env stores wxyz; fractal uses xyzw
    base = np.concatenate([p[:3], quat_xyzw]).astype(np.float32)
    return base, np.array([1.0 - p[7]], np.float32)


def collect_fractal_demos(
    n_episodes: int,
    seed: int = 0,
    render_size: int = 112,
    hold_steps: int = 4,
    max_steps: Optional[int] = None,
    target: Optional[str] = None,
    start_coverage: bool = False,
    balance_targets: bool = False,
) -> Tuple[List[dict], float]:
    """Roll the drawer expert; returns (episodes in the raw
    fractal20220817_data step schema, frames JPEG-encoded; expert success
    rate). Unlike the bridge tasks there is no action relabel from proprio
    (rt1_transform keeps world_vector as-is), so no closing frame is
    appended."""
    from open_pi_zero_torch.data.jpeg import encode_jpeg

    env = DrawerEnv(seed=seed, render_size=render_size,
                    max_steps=int(max_steps or 112), target=target)
    episodes, successes = [], []
    for ep_id in range(n_episodes):
        if balance_targets and target is None:
            # EXACT per-language-target balance (ep_id mod 3) instead of
            # the episode-keyed random draw: the language-grounding lever
            # needs each "open the {top,middle,bottom} drawer" instruction
            # equally represented in the no-coverage primary dataset.
            # Layouts and starts stay episode-keyed (reset() below), only
            # the target assignment is overridden.
            env._fixed_target = ep_id % 3
        obs, _ = env.reset(options={"obj_init_options": {"episode_id": ep_id}})
        rng = np.random.default_rng((seed, ep_id, 23))
        if start_coverage:
            obs = env.randomize_start(rng)
        # DETERMINISTIC early close (see drawer_expert's docstring for the
        # two measured failure modes this replaces): the gripper command
        # is a consistent function of handle distance, and the slow
        # squeeze-while-approaching inside 2x grasp radius puts
        # closed-at/near-handle states in the demos — the trajectory
        # shape the eval-side sticky machine produces
        close_dist = 2.0 * GRASP_RADIUS
        images, bases, grips, wv, rot, gca = [], [], [], [], [], []
        success_at = None
        while True:
            act = drawer_expert(env, rng, close_dist=close_dist)
            images.append(encode_jpeg(obs["image"]))
            base, gc = fractal_proprio_parts(obs)
            bases.append(base)
            grips.append(gc)
            wv.append(act[:3])
            rot.append(act[3:6])
            gca.append(act[6:7])
            obs, _, success, truncated, _ = env.step(act)
            if success and success_at is None:
                success_at = env.t
            if truncated or (success_at is not None and env.t >= success_at + hold_steps):
                break
        successes.append(bool(success))
        if not success:
            continue  # demos are demonstrations: drop the (rare) failures
        n = len(images)
        episodes.append(
            {
                "steps": {
                    "observation": {
                        "image": images,
                        "base_pose_tool_reached": np.stack(bases),
                        "gripper_closed": np.stack(grips),
                        "natural_language_instruction": [
                            env.get_language_instruction().encode()
                        ] * n,
                    },
                    "action": {
                        "world_vector": np.stack(wv),
                        "rotation_delta": np.stack(rot),
                        "gripper_closedness_action": np.stack(gca),
                    },
                },
                "episode_metadata": {"file_path": f"/sim/drawer_ep{ep_id}".encode()},
            }
        )
    return episodes, float(np.mean(successes))


def write_fractal_demo_dataset(
    data_dir: str,
    n_episodes: int,
    seed: int = 0,
    render_size: int = 112,
    shards: int = 4,
    max_steps: Optional[int] = None,
    dataset_name: str = "fractal20220817_data",
    target: Optional[str] = None,
    start_coverage: bool = False,
    balance_targets: bool = False,
) -> float:
    """Collect drawer demos and write them as a raw fractal20220817_data
    RLDS dir in the layout the fractal pipeline (registry entry +
    rt1_transform, data/oxe.py) reads. Returns the expert success rate."""
    from open_pi_zero_torch.data import rlds

    episodes, expert_rate = collect_fractal_demos(
        n_episodes, seed=seed, render_size=render_size, max_steps=max_steps,
        target=target, start_coverage=start_coverage,
        balance_targets=balance_targets,
    )
    leaves = [
        rlds.LeafSpec(
            "steps/observation/image", "uint8",
            (render_size, render_size, 3), "image", True, "jpeg",
        ),
        rlds.LeafSpec(
            "steps/observation/base_pose_tool_reached", "float32", (7,),
            "tensor", True,
        ),
        rlds.LeafSpec(
            "steps/observation/gripper_closed", "float32", (1,), "tensor", True
        ),
        rlds.LeafSpec(
            "steps/observation/natural_language_instruction", "string", (),
            "text", True,
        ),
        rlds.LeafSpec("steps/action/world_vector", "float32", (3,), "tensor", True),
        rlds.LeafSpec("steps/action/rotation_delta", "float32", (3,), "tensor", True),
        rlds.LeafSpec(
            "steps/action/gripper_closedness_action", "float32", (1,),
            "tensor", True,
        ),
        rlds.LeafSpec("episode_metadata/file_path", "string", (), "text", False),
    ]
    rlds.write_rlds_dataset(
        data_dir, dataset_name, episodes, leaves, shards=min(shards, n_episodes)
    )
    return expert_rate


def register_drawer_lever_mix(cov_weight: float = 0.5) -> str:
    """The drawer language-grounding lever mix: PRIMARY = no-coverage
    per-target-balanced demos (episode-keyed default starts ground the
    language instruction — the expert goes to the COMMANDED handle, and
    with balanced targets no nearest-handle shortcut fits all three),
    SECONDARY = full-workspace coverage starts at a lower weight (state
    diversity for the servo field without letting the nearest-handle
    local fit dominate). Mirrors how the reference's OXE mixes pair
    narrow teleop data with play data at unequal weights
    (reference src/data/oxe/mixes.py). Returns the mix name."""
    from open_pi_zero_torch.data import oxe

    if "fractal_drawer_cov" not in oxe.REGISTRY:
        oxe.REGISTRY["fractal_drawer_cov"] = dict(
            oxe.REGISTRY["fractal20220817_data"]
        )
        oxe.STANDARDIZE_FNS["fractal_drawer_cov"] = oxe.rt1_transform
    oxe.MIXES["fractal_drawer_lever"] = [
        ("fractal20220817_data", 1.0),
        ("fractal_drawer_cov", float(cov_weight)),
    ]
    return "fractal_drawer_lever"
