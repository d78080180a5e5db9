"""The port's SimplerLite demo writers against the JAX package's, on the CPU
(numpy on both sides, the same seeds).

- ``collect_demos`` (reach, pick_place) and ``collect_fractal_demos``
  (``target``, ``start_coverage``, ``balance_targets``): states, actions,
  instructions, file paths, episode lengths and the expert rate bitwise
  JAX's, frames included: each frame's JPEG bytes (the port's codec) equal
  JAX's (``tf.io.encode_jpeg``), and the frame is the env's render,
  replayed from the recorded actions, through that encoder.
- ``DrawerEnv.randomize_start`` from the same generator: the start, the
  frame and the generator's state after it, bitwise.
- ``quat2euler``, ``axangle2mat``, ``isrotation``: bitwise on random inputs.
- After each ``register_*``: the port's REGISTRY entries (enums by name),
  STANDARDIZE_FNS (by function name) and MIXES equal JAX's.
- A dataset written by the port's writers, and one written by JAX's
  (reach in the bridge schema and drawer in the fractal one, JPEG frames),
  read by the port's pipeline and by JAX's TF pipeline, gives the same
  frames as a multiset, bitwise (as tests/test_torch_data_pipeline.py
  compares them).
- The diagnostic inputs of ``tests/demo_reference_inputs.py``: the JAX
  package's init, exported through its CLI at the bridge geometry, at
  proprio 8 and at the scale-up's 8 Q / 1 KV heads of 32, is bitwise what
  ``demo_closed_loop --init-params`` makes the TrainAgent start from.
"""

import logging

import numpy as np
import pytest
import tensorflow as tf
import torch

from open_pi_zero_torch import envs as t_envs
from open_pi_zero_torch.agents.train import TrainAgent
from open_pi_zero_torch.data import jpeg as t_jpeg
from open_pi_zero_torch.data import oxe as t_oxe
from open_pi_zero_torch.data import pipeline as t_pipeline
from open_pi_zero_torch.scripts import demo_closed_loop
from open_pi_zero_torch.utils import geometry as t_geometry
from open_pi_zero_tpu import envs as j_envs
from open_pi_zero_tpu.data import oxe as j_oxe
from open_pi_zero_tpu.data import pipeline as j_pipeline
from open_pi_zero_tpu.utils import geometry as j_geometry
from tests import demo_reference_inputs
from tests.test_torch_data_pipeline import flat, frames_of

tf.config.set_visible_devices([], "GPU")

EPISODES = 3


def replay_bridge(task, episode, seed=0):
    """The env's renders along an episode's recorded actions: the frame
    before each step, then the closing frame."""
    spec = t_envs.TASKS[task]
    env = spec["env"](seed=seed, render_size=112, max_steps=spec["max_steps"])
    ep_id = int(episode["episode_metadata"]["file_path"].decode().rsplit("ep", 1)[1])
    obs, _ = env.reset(options={"obj_init_options": {"episode_id": ep_id}})
    frames = [obs["image"]]
    for act in episode["steps"]["action"][:-1]:  # the closing frame repeats the last action
        obs = env.step(np.concatenate([act[:6], [2.0 * (act[6] > 0.5) - 1.0]]))[0]
        frames.append(obs["image"])
    return frames


def replay_drawer(episode, seed=0, target=None, start_coverage=False, balance_targets=False):
    """The drawer env's render before each recorded step."""
    env = t_envs.DrawerEnv(seed=seed, render_size=112, max_steps=112, target=target)
    ep_id = int(episode["episode_metadata"]["file_path"].decode().rsplit("ep", 1)[1])
    if balance_targets and target is None:
        env._fixed_target = ep_id % 3
    obs, _ = env.reset(options={"obj_init_options": {"episode_id": ep_id}})
    if start_coverage:
        obs = env.randomize_start(np.random.default_rng((seed, ep_id, 23)))
    frames = []
    action = episode["steps"]["action"]
    for i in range(len(action["world_vector"])):
        frames.append(obs["image"])
        obs = env.step(np.concatenate([action["world_vector"][i], action["rotation_delta"][i],
                                       action["gripper_closedness_action"][i]]))[0]
    return frames


def check_frames(port_bytes, jax_bytes, renders):
    assert len(port_bytes) == len(jax_bytes) == len(renders)
    assert np.array_equal(np.array(port_bytes, dtype=object), np.array(jax_bytes, dtype=object))
    assert [t_jpeg.encode_jpeg(r) for r in renders] == list(port_bytes)


@pytest.mark.parametrize("task", ["reach", "pick_place"])
def test_collect_demos_is_jax_s(task):
    got, got_rate = t_envs.collect_demos(EPISODES, seed=0, task=task)
    want, want_rate = j_envs.collect_demos(EPISODES, seed=0, task=task)
    assert got_rate == want_rate == 1.0 and len(got) == len(want) == EPISODES
    for a, b in zip(got, want):
        sa, sb = a["steps"], b["steps"]
        assert a["episode_metadata"] == b["episode_metadata"]
        for name in ("state",):
            x, y = sa["observation"][name], sb["observation"][name]
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert sa["action"].dtype == sb["action"].dtype and np.array_equal(sa["action"], sb["action"])
        assert sa["language_instruction"] == sb["language_instruction"]
        check_frames(sa["observation"]["image_0"], sb["observation"]["image_0"], replay_bridge(task, a))


@pytest.mark.parametrize("kwargs", [
    dict(target="top", start_coverage=True),
    dict(balance_targets=True),
    dict(start_coverage=True, balance_targets=True),
])
def test_collect_fractal_demos_is_jax_s(kwargs):
    got, got_rate = t_envs.collect_fractal_demos(EPISODES, seed=0, **kwargs)
    want, want_rate = j_envs.collect_fractal_demos(EPISODES, seed=0, **kwargs)
    assert got_rate == want_rate and len(got) == len(want) > 0
    for a, b in zip(got, want):
        oa, ob = a["steps"]["observation"], b["steps"]["observation"]
        assert a["episode_metadata"] == b["episode_metadata"]
        for name in ("base_pose_tool_reached", "gripper_closed"):
            assert oa[name].dtype == ob[name].dtype and np.array_equal(oa[name], ob[name])
        for name, x in a["steps"]["action"].items():
            y = b["steps"]["action"][name]
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert oa["natural_language_instruction"] == ob["natural_language_instruction"]
        check_frames(oa["image"], ob["image"], replay_drawer(a, **kwargs))


def test_randomize_start_is_jax_s():
    for seed in (0, 3):
        for ep_id in range(6):
            envs = [t_envs.DrawerEnv(seed=seed), j_envs.DrawerEnv(seed=seed)]
            rngs = [np.random.default_rng((seed, ep_id, 23)) for _ in envs]
            obs = [env.reset(options={"obj_init_options": {"episode_id": ep_id}})[0] for env in envs]
            obs = [env.randomize_start(rng) for env, rng in zip(envs, rngs)]
            assert np.array_equal(envs[0].eef, envs[1].eef)
            assert np.array_equal(obs[0]["image"], obs[1]["image"])
            assert np.array_equal(obs[0]["agent"]["eef_pos"], obs[1]["agent"]["eef_pos"])
            assert rngs[0].bit_generator.state == rngs[1].bit_generator.state


def test_geometry_functions_are_jax_s():
    rng = np.random.default_rng(0)
    for _ in range(200):
        q = rng.normal(size=4)
        assert t_geometry.quat2euler(q) == j_geometry.quat2euler(q)
        axis, angle = rng.normal(size=3), float(rng.uniform(-4, 4))
        m = t_geometry.axangle2mat(axis, angle)
        assert np.array_equal(m, j_geometry.axangle2mat(axis, angle))
        noisy = m + rng.normal(0, 1e-4, size=(3, 3))
        for x in (m, noisy, -m, m[:2]):
            assert t_geometry.isrotation(x) == j_geometry.isrotation(x)
        assert t_geometry.isrotation(m) and not t_geometry.isrotation(noisy)


@pytest.fixture
def restore_registries():
    """Both packages' OXE tables as they were before the test."""
    saved = [(mod, name, dict(getattr(mod, name))) for mod in (t_oxe, j_oxe)
             for name in ("REGISTRY", "STANDARDIZE_FNS", "MIXES")]
    yield
    for mod, name, table in saved:
        getattr(mod, name).clear()
        getattr(mod, name).update(table)


def comparable(entry: dict) -> dict:
    return {k: v.name if hasattr(v, "name") and not isinstance(v, dict) else v for k, v in entry.items()}


@pytest.mark.parametrize("register", [
    "register_simpler_lite_mix", "register_simpler_lite_tri_mix", "register_simpler_lite_tri_lever_mix",
    "register_drawer_lever_mix",
])
def test_registered_mixes_are_jax_s(register, restore_registries):
    tables = ("REGISTRY", "STANDARDIZE_FNS", "MIXES")
    before = {mod: {name: set(getattr(mod, name)) for name in tables} for mod in (t_oxe, j_oxe)}
    assert getattr(t_envs, register)() == getattr(j_envs, register)()
    added = {mod: {name: set(getattr(mod, name)) - before[mod][name] for name in tables} for mod in (t_oxe, j_oxe)}
    assert added[t_oxe] == added[j_oxe] and added[t_oxe]["MIXES"]
    for name in added[j_oxe]["REGISTRY"]:
        assert comparable(t_oxe.REGISTRY[name]) == comparable(j_oxe.REGISTRY[name]), name
    for name in added[j_oxe]["STANDARDIZE_FNS"]:
        assert t_oxe.STANDARDIZE_FNS[name].__name__ == j_oxe.STANDARDIZE_FNS[name].__name__, name
    for name in added[j_oxe]["MIXES"]:
        assert t_oxe.MIXES[name] == j_oxe.MIXES[name], name


def key(frame):
    """A frame's identity: its dataset, instruction, timesteps and proprio
    (demos of one instruction share the rest)."""
    return (frame["dataset_name"], frame["task"]["language_instruction"],
            tuple(frame["observation"]["timestep"].tolist()), frame["observation"]["proprio"].tobytes())


@pytest.fixture
def hermetic_cache(tmp_path, monkeypatch):
    """Both packages' statistics caches under this test's directory."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))


@pytest.mark.parametrize("writer", [t_envs, j_envs], ids=["port_written", "jax_written"])
def test_port_written_demos_are_the_same_frames_in_both_pipelines(writer, tmp_path, hermetic_cache):
    root = tmp_path / "oxe"
    size = 28  # the frames stay at their own size: bitwise
    assert writer.write_demo_dataset(str(root / "bridge_dataset"), 3, seed=0, render_size=size, shards=2) == 1.0
    assert writer.write_fractal_demo_dataset(str(root / "fractal20220817_data"), 2, seed=0, render_size=size,
                                             shards=2, target="middle") == 1.0
    want, _ = frames_of(j_pipeline, j_oxe, str(root), "oxe_simple", size)
    got, _ = frames_of(t_pipeline, t_oxe, str(root), "oxe_simple", size)
    assert len(got) == len(want) > 0
    assert {f["dataset_name"] for f in got} == {b"bridge_dataset", b"fractal20220817_data"}
    by_key = {key(f): f for f in want}
    assert len(by_key) == len(want)
    assert sorted(by_key) == sorted(key(f) for f in got)
    for frame in got:
        a, b = dict(flat(frame)), dict(flat(by_key[key(frame)]))
        assert a.keys() == b.keys()
        for name in b:
            assert a[name].shape == b[name].shape, name
            if b[name].dtype == object or b[name].dtype.kind == "S":
                assert a[name].tolist() == b[name].tolist(), name
            else:
                assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]), name


def leaves_by_path(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves_by_path(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v.detach() if torch.is_tensor(v) else v)


@pytest.mark.parametrize("proprio_dim, heads, kv_heads, head_dim", [
    (7, 4, 1, 0),  # the bridge family's geometry
    (8, 4, 1, 0),  # the drawer family's and the cross-family mixes' proprio
    (7, 8, 1, 32),  # the scale-up's 8 Q / 1 KV heads of 32
], ids=["bridge", "proprio8", "scale_up_heads"])
def test_jax_init_export_is_what_init_params_trains_from(proprio_dim, heads, kv_heads, head_dim, tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    heads_flags = ["--heads", str(heads), "--kv-heads", str(kv_heads), "--head-dim", str(head_dim)]
    demo_reference_inputs.main(["--init", str(tmp_path / "init"), "--hidden", "32", "--layers", "1",
                                "--proprio-dim", str(proprio_dim), *heads_flags])
    tree = demo_reference_inputs.jax_init_export(str(tmp_path / "again"), hidden=32, layers=1,
                                                 proprio_dim=proprio_dim, heads=heads, kv_heads=kv_heads,
                                                 head_dim=head_dim)
    args = demo_closed_loop.parse_args(["--workdir", str(tmp_path), "--init-params", str(tmp_path / "init"),
                                        "--seed", "3", "--n-demos", "2", "--hidden", "32", "--layers", "1",
                                        *heads_flags, "--device", "cpu"])
    mix, demo_sets = demo_closed_loop.demo_sets_of(args.task)
    data_dir = str(tmp_path / "rlds")
    demo_closed_loop.write_demos(args, demo_sets, data_dir, logging.getLogger("demo"))
    geometry = demo_closed_loop.model_geometry(32, 1, proprio_dim=proprio_dim, heads=heads, kv_heads=kv_heads,
                                               head_dim=head_dim)
    cfg = demo_closed_loop.train_config(args, geometry, mix, data_dir, 1, False)
    agent = TrainAgent(cfg, device="cpu")
    got, want = dict(leaves_by_path(agent.state.params)), dict(leaves_by_path(tree))
    assert agent.seed == 3 and got.keys() == want.keys()
    assert demo_closed_loop.init_source(args.init_params) == "open_pi_zero_tpu init, jax.random.key(0)"
    assert demo_closed_loop.init_source(None) is None
    for name in want:
        assert got[name].dtype == want[name].dtype and np.array_equal(got[name], want[name]), name
