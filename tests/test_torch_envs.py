"""The port's SimplerLite envs (``open_pi_zero_torch/envs/``) and its
rotation helpers (``utils/geometry.py``) against the JAX package's.

Both are numpy: the same seeds, episode ids and actions must give bitwise
the same frames, proprio, rewards, success, truncation and instructions,
under each package's scripted expert (the same expert rng on both sides)
and under a seeded random action stream.
"""

import math

import numpy as np
import pytest

from open_pi_zero_torch import envs as t_envs
from open_pi_zero_torch.envs import drawer_env as t_drawer
from open_pi_zero_torch.envs import pick_place_env as t_pp
from open_pi_zero_torch.envs import reach_env as t_reach
from open_pi_zero_torch.utils import geometry as t_geo
from open_pi_zero_tpu import envs as j_envs
from open_pi_zero_tpu.envs import drawer_env as j_drawer
from open_pi_zero_tpu.envs import pick_place_env as j_pp
from open_pi_zero_tpu.envs import reach_env as j_reach
from open_pi_zero_tpu.utils import geometry as j_geo

# name -> (task name of make_env, expert of each package, True if the
# expert speaks the dataset's gripper convention that demo collection turns
# into a +-1 command)
ENVS = {
    "reach": ("simpler_lite_reach", t_reach.scripted_expert, j_reach.scripted_expert, True),
    "reach_multi": ("simpler_lite_reach_multi", t_reach.scripted_expert, j_reach.scripted_expert, True),
    "pick_place": ("simpler_lite_pick_place", t_pp.pick_place_expert, j_pp.pick_place_expert, True),
    "drawer": ("simpler_lite_drawer", t_drawer.drawer_expert, j_drawer.drawer_expert, False),
    "drawer_top": ("simpler_lite_drawer_top", t_drawer.drawer_expert, j_drawer.drawer_expert, False),
    "drawer_middle": ("simpler_lite_drawer_middle", t_drawer.drawer_expert, j_drawer.drawer_expert, False),
    "drawer_bottom": ("simpler_lite_drawer_bottom", t_drawer.drawer_expert, j_drawer.drawer_expert, False),
}


def _assert_obs_equal(a, b):
    assert a.keys() == b.keys()
    np.testing.assert_array_equal(a["image"], b["image"])
    assert a["image"].dtype == b["image"].dtype == np.uint8
    np.testing.assert_array_equal(a["agent"]["eef_pos"], b["agent"]["eef_pos"])
    assert a["agent"]["eef_pos"].dtype == b["agent"]["eef_pos"].dtype


def _rollout_pair(name, policy, seed, episodes):
    """Run the port's and the JAX package's env through ``episodes`` episodes
    (the first reset with the seed, later ones by episode id alone, as
    EvalAgent.run resets) and hold every step bitwise. ``policy(env, rng,
    expert)`` gives the step's command. Returns the steps and successes."""
    task, t_expert, j_expert, _ = ENVS[name]
    pair = {"torch": (t_envs.make_env(task, seed=seed), t_expert), "jax": (j_envs.make_env(task, seed=seed), j_expert)}
    steps, successes = 0, []
    for ep in range(episodes):
        out = {}
        for side, (env, _) in pair.items():
            opts = {"obj_init_options": {"episode_id": ep}}
            out[side] = env.reset(seed=seed, options=opts) if ep == 0 else env.reset(options=opts)
        _assert_obs_equal(out["torch"][0], out["jax"][0])
        assert out["torch"][1] == out["jax"][1] == {}
        rngs = {side: np.random.default_rng((seed, ep, 7)) for side in pair}
        while True:
            res, instr = {}, {}
            for side, (env, expert) in pair.items():
                res[side] = env.step(policy(env, rngs[side], expert))
                instr[side] = env.get_language_instruction()
            (t_obs, *t_rest), (j_obs, *j_rest) = res["torch"], res["jax"]
            _assert_obs_equal(t_obs, j_obs)
            assert t_rest == j_rest and instr["torch"] == instr["jax"]
            assert type(t_rest[0]) is type(j_rest[0]) and type(t_rest[1]) is type(j_rest[1])
            steps += 1
            if t_rest[2]:  # truncated
                successes.append(bool(t_rest[1]))
                break
    return steps, successes


def _expert_command(name):
    dataset_gripper = ENVS[name][3]

    def policy(env, rng, expert):
        act = expert(env, rng)
        if dataset_gripper:  # as demo collection steps the env: gripper -> +-1
            act = np.concatenate([act[:6], [2.0 * (act[6] > 0.5) - 1.0]])
        return act

    return policy


def _random_command(env, rng, expert):
    return np.concatenate([rng.uniform(-0.04, 0.04, 2), rng.normal(0, 0.1, 4), rng.uniform(-1, 1, 1)])


@pytest.mark.parametrize("name", list(ENVS))
def test_env_under_the_expert_is_bitwise_the_jax_env(name):
    steps, successes = _rollout_pair(name, _expert_command(name), seed=3, episodes=3)
    assert steps > 0
    # the experts solve their task: a rollout that never succeeds would
    # leave the success paths untested
    assert any(successes), successes


@pytest.mark.parametrize("name", list(ENVS))
def test_env_under_random_actions_is_bitwise_the_jax_env(name):
    steps, _ = _rollout_pair(name, _random_command, seed=11, episodes=2)
    assert steps > 0


def test_make_env_dispatch_matches():
    for task in ("simpler_lite_reach", "simpler_lite_reach_multi", "simpler_lite_pick_place", "simpler_lite_drawer",
                 "simpler_lite_drawer_top", "simpler_lite_drawer_middle", "simpler_lite_drawer_bottom"):
        t_env, j_env = t_envs.make_env(task, seed=5), j_envs.make_env(task, seed=5)
        assert type(t_env).__name__ == type(j_env).__name__
        for attr in ("base_seed", "render_size", "max_steps", "multi_subtask", "_fixed_target"):
            assert getattr(t_env, attr, None) == getattr(j_env, attr, None), (task, attr)
    for task in ("simpler_lite_nope", "widowx_carrot_on_plate"):
        with pytest.raises(ValueError) as t_err:
            t_envs.make_env(task)
        with pytest.raises(ValueError) as j_err:
            j_envs.make_env(task)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError) as t_err:
        t_envs.make_env("simpler_lite_drawer_left")
    with pytest.raises(ValueError) as j_err:
        j_envs.make_env("simpler_lite_drawer_left")
    assert str(t_err.value) == str(j_err.value)
    assert {k: (v["env"].__name__, v["expert"].__name__, v["max_steps"]) for k, v in t_envs.TASKS.items()} == {
        k: (v["env"].__name__, v["expert"].__name__, v["max_steps"]) for k, v in j_envs.TASKS.items()
    }


def test_constants_and_proprio_helpers_match():
    assert t_reach.INSTRUCTIONS == j_reach.INSTRUCTIONS and t_reach.COLORS == j_reach.COLORS
    assert t_pp.INSTRUCTION == j_pp.INSTRUCTION and t_drawer.INSTRUCTIONS == j_drawer.INSTRUCTIONS
    for name in ("WORKSPACE", "BLOCK_RANGE", "BLOCK_HALF", "EEF_RADIUS", "MAX_STEP", "SUCCESS_RADIUS",
                 "MIN_BLOCK_SEP", "MIN_START_DIST", "EEF_Z"):
        assert getattr(t_reach, name) == getattr(j_reach, name), name
    np.testing.assert_array_equal(t_reach.EEF_QUAT_WXYZ, j_reach.EEF_QUAT_WXYZ)
    rng = np.random.default_rng(0)
    for _ in range(20):
        q = rng.normal(size=4)
        obs = {"agent": {"eef_pos": np.concatenate([rng.normal(size=3), q / np.linalg.norm(q), rng.uniform(0, 1, 1)])}}
        np.testing.assert_array_equal(t_reach.bridge_proprio(obs), j_reach.bridge_proprio(obs))
        for a, b in zip(t_drawer.fractal_proprio_parts(obs), j_drawer.fractal_proprio_parts(obs)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def _assert_same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and (a == b or (math.isnan(a) and math.isnan(b)))


def test_geometry_is_bitwise_the_jax_geometry():
    rng = np.random.default_rng(0)
    angles = [tuple(rng.uniform(-math.pi, math.pi, 3)) for _ in range(200)]
    # gimbal lock (pitch +-pi/2) and the identity
    angles += [(0.3, math.pi / 2, -1.1), (-0.7, -math.pi / 2, 0.4), (0.0, 0.0, 0.0)]
    quats = [rng.normal(size=4) for _ in range(200)]
    quats += [np.array([1.0, 0, 0, 0]), np.array([-1.0, 0, 0, 0]), np.zeros(4), np.array([0.0, 1, 0, 0])]
    for e in angles:
        for fn in ("euler2mat", "euler2quat", "euler2axangle"):
            _assert_same(getattr(t_geo, fn)(*e), getattr(j_geo, fn)(*e))
        m = j_geo.euler2mat(*e)
        _assert_same(t_geo.mat2euler(m), j_geo.mat2euler(m))
        _assert_same(t_geo.mat2quat(m), j_geo.mat2quat(m))
    for q in quats:
        _assert_same(t_geo.quat2mat(q), j_geo.quat2mat(q))
        if np.linalg.norm(q) > 0:
            _assert_same(t_geo.quat2axangle(q), j_geo.quat2axangle(q))
            m = j_geo.quat2mat(q)
            _assert_same(t_geo.mat2euler(m), j_geo.mat2euler(m))
            _assert_same(t_geo.mat2quat(m), j_geo.mat2quat(m))
