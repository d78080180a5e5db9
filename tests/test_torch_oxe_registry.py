"""The port's extended OXE registry (``open_pi_zero_torch/data/
oxe_registry.py``, merged by ``data/oxe.py``) against the JAX package's on
the CPU.

- Every registry key and mix of the JAX package is in the port with equal
  kwargs: names, image and depth keys, encodings (by name), normalization
  masks and weights; the standardization function by name.
- Every standardization transform runs on a synthetic raw trajectory with
  its dataset's keys (made with numpy from a seed; TensorFlow tensors of
  the same values for the JAX side). The outputs hold the same keys;
  integer, boolean and byte leaves are bitwise JAX's, float leaves within
  1e-6 (the quaternion and navigation transforms take float32 arctan,
  arcsin and norms, whose last bits may differ between the two libraries).
- A name that neither package registers raises in both.
"""

import zlib

import numpy as np
import pytest
import tensorflow as tf

from open_pi_zero_torch.data import oxe as t_oxe
from open_pi_zero_tpu.data import oxe as j_oxe
from open_pi_zero_tpu.data import oxe_registry as j_registry

tf.config.set_visible_devices([], "GPU")

T = 10  # steps of a raw trajectory (a multiple of neither 3 nor 5)
FLOAT_ATOL = 1e-6

# Raw schemas, one per transform: a number is a float32 [T, n] leaf, "f" a
# float32 [T], "b" a bool [T], "i<n>" an int64 [T, n], "s" strings [T],
# "z<n>" zlib-compressed float32 records of n values, "d" an int32 depth
# [T, 4, 4, 1], "u" padded unicode codepoints (int32 [T, 24]).
WV = {"world_vector": 3, "rotation_delta": 3}
LANG = {"natural_language_instruction": "s"}
SCHEMAS = {
    "kuka": dict(action={**WV, "gripper_closedness_action": 1},
                 observation={"clip_function_input/base_pose_tool_reached": "z7", "gripper_closed": "z1", **LANG}),
    "taco_play": dict(action={"rel_actions_world": 7}, observation={"robot_obs": 15, **LANG}),
    "jaco_play": dict(action={"world_vector": 3, "gripper_closedness_action": 1},
                      observation={"end_effector_cartesian_pos": 7, **LANG}),
    "berkeley_cable_routing": dict(action=dict(WV), observation={"robot_state": 7, **LANG}),
    "roboturk": dict(action={**WV, "gripper_closedness_action": 1}, observation=dict(LANG)),
    "nyu_door_opening": dict(action={**WV, "gripper_closedness_action": 1}, observation=dict(LANG)),
    "viola": dict(action={**WV, "gripper_closedness_action": "f"},
                  observation={"joint_states": 7, "gripper_states": 1, **LANG}),
    "berkeley_autolab_ur5": dict(action={**WV, "gripper_closedness_action": "f"},
                                 observation={"image_with_depth": "s", "robot_state": 15, **LANG}),
    "toto": dict(action={**WV, "open_gripper": "b"}, observation={"state": 7, **LANG}),
    "language_table": dict(action=2, observation={"effector_translation": 2, "instruction": "u"}),
    "pusht": dict(action={**WV, "gripper_closedness_action": "f"}, observation={"robot_state": 2, **LANG}),
    "stanford_kuka_multimodal": dict(action=7, observation={"depth_image": "d", "ee_position": 3,
                                                            "ee_orientation": 4}),
    "nyu_rot": dict(action=9, observation={"state": 7}),
    "stanford_hydra": dict(action=7, observation={"state": 27}, language_instruction="s"),
    "austin_buds": dict(action=7, observation={"state": 24}, language_instruction="s"),
    "nyu_franka_play": dict(action=15, observation={"depth": "d", "depth_additional_view": "d", "state": 13},
                            language_instruction="s"),
    "maniskill": dict(action=7, observation={"tcp_pose": 7, "state": 18}),
    "furniture_bench": dict(action=8, observation={"state": 35}),
    "cmu_franka_exploration": dict(action=8, observation={}),
    "ucsd_kitchen": dict(action=8, observation={"state": 21}),
    "ucsd_pick_place": dict(action=4, observation={"state": 7}),
    "austin_sailor": dict(action=7, observation={"state": 8}, language_instruction="s"),
    "austin_sirius": dict(action=7, observation={"state": 8}, language_instruction="s"),
    "bc_z": dict(action={"future/xyz_residual": 30, "future/axis_angle_residual": 30, "future/target_close": "i10"},
                 observation={"present/xyz": 3, "present/axis_angle": 3, "present/sensed_close": 1, **LANG}),
    "utokyo_pr2": dict(action=8, observation={"state": 7}),
    "utokyo_xarm_pick_place": dict(action=7, observation={"end_effector_pose": 6}),
    "utokyo_xarm_bimanual": dict(action=14, observation={"end_effector_pose": 12}),
    "robo_net": dict(action=5, observation={"state": 5}),
    "berkeley_mvp": dict(action=8, observation={"pose": 7, "gripper": "b"}),
    "berkeley_rpt": dict(action=8, observation={"joint_pos": 7, "gripper": "b"}),
    "kaist_nonprehensile": dict(action=20, observation={"state": 21}),
    "stanford_mask_vit": dict(action=5, observation={"end_effector_pose": 5}),
    "tokyo_lsmo": dict(action=7, observation={"state": 13}),
    "dlr_sara_pour": dict(action=7, observation={"state": 6}),
    "dlr_sara_grid_clamp": dict(action=7, observation={"state": 12}),
    "dlr_edan_shared_control": dict(action=7, observation={"state": 12}),
    "asu_table_top": dict(action=7, observation={"state": 7}, ground_truth_states={"EE": 6}),
    "robocook": dict(action=7, observation={"state": 15}),
    "imperial_wristcam": dict(action=8, observation={}),
    "iamlab_pick_insert": dict(action=8, observation={"state": 20}),
    "uiuc_d3field": dict(action=3, observation={}),
    "utaustin_mutex": dict(action=7, observation={"state": 24}, language_instruction="s"),
    "berkeley_fanuc": dict(action=6, observation={"state": 13}),
    "cmu_playing_with_food": dict(action=8, observation={"state": 7}),
    "playfusion": dict(action=9, observation={"state": 8}),
    "cmu_stretch": dict(action=8, observation={"state": 4}),
    "gnm": dict(action=2, observation={"position": 2, "yaw": 1, "state": 3}),
    "aloha": dict(action=14, observation={"state": 14}),
    "fmb": dict(action=7, observation={"eef_pose": 7, "state_gripper_pose": "f"}),
    "dobbe": dict(action=7, observation={"state": 8}),
    "roboset": dict(action=8, observation={"state": 8}),
    "rh20t": dict(action={"tcp_base": 7, "gripper": "f"}, observation={"tcp_base": 7, "gripper_width": "f"}),
    "mujoco_manip": dict(action=7, observation={"state": 7}),
}


def strings(values):
    out = np.empty(len(values), object)
    out[:] = list(values)
    return out


def leaf(kind, rng, t=T):
    if isinstance(kind, int):
        # gripper-like ranges: below 0, inside [0, 1] and above 1, and the
        # relative commands' +-0.1 thresholds
        return rng.choice([-1.2, -0.5, 0.0, 0.03, 0.5, 0.97, 1.0, 1.5], size=(t, kind)).astype(np.float32) \
            + rng.normal(0, 0.01, size=(t, kind)).astype(np.float32)
    if kind == "f":
        return rng.uniform(-1.5, 1.5, size=t).astype(np.float32)
    if kind == "b":
        return rng.uniform(size=t) < 0.5
    if kind.startswith("i"):
        return rng.integers(0, 2, size=(t, int(kind[1:]))).astype(np.int64)
    if kind == "s":
        return strings([f"step {i}".encode() for i in range(t)])
    if kind.startswith("z"):
        n = int(kind[1:])
        return strings([zlib.compress(rng.normal(size=n).astype("<f4").tobytes()) for _ in range(t)])
    if kind == "d":
        return rng.integers(0, 5000, size=(t, 4, 4, 1)).astype(np.int32)
    if kind == "u":
        words = ["push the red star", "move the blue cube left", "séparer les blocs"]
        rows = np.zeros((t, 24), np.int32)
        for i in range(t):
            text = words[i % 3][:24]
            rows[i, :len(text)] = [ord(ch) for ch in text]
        return rows
    raise ValueError(kind)


def raw_trajectory(schema, seed, t=T):
    rng = np.random.default_rng(seed)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return leaf(node, rng, t)

    return build(schema)


def to_tf(tree):
    if isinstance(tree, dict):
        return {k: to_tf(v) for k, v in tree.items()}
    return tf.constant(tree)


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v.numpy() if hasattr(v, "numpy") else v)


def assert_outputs_equal(got, want):
    got, want = dict(flat(got)), dict(flat(want))
    assert got.keys() == want.keys()
    for name, b in want.items():
        a = got[name]
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if b.dtype == object:
            assert a.dtype == object and a.reshape(-1).tolist() == b.reshape(-1).tolist(), name
        elif b.dtype.kind == "f":
            assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
            assert np.allclose(a, b, rtol=0, atol=FLOAT_ATOL), (name, float(np.abs(a - b).max()))
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def comparable(entry: dict) -> dict:
    out = {k: v.name if hasattr(v, "name") and not isinstance(v, dict) else v for k, v in entry.items()}
    if out.get("standardize_fn") is not None:
        out["standardize_fn"] = out["standardize_fn"].__name__
    return out


def test_every_registry_entry_and_mix_is_jax_s():
    assert set(j_oxe.REGISTRY) <= set(t_oxe.REGISTRY)
    assert set(j_registry.EXTENDED_REGISTRY) <= set(t_oxe.REGISTRY)
    for name, entry in j_oxe.REGISTRY.items():
        assert comparable(t_oxe.REGISTRY[name]) == comparable(entry), name
    for name, fn in j_oxe.STANDARDIZE_FNS.items():
        assert t_oxe.STANDARDIZE_FNS[name].__name__ == fn.__name__, name
    for name in ("rtx", "rtx_franka", "oxe_franka", "oxe_magic_soup", "oxe_flex_act_soup", "oxe_full"):
        assert t_oxe.MIXES[name] == j_oxe.MIXES[name], name
    for mix in j_oxe.MIXES:
        for views in (("primary",), ("primary", "secondary", "wrist")):
            want_kw, want_w = j_oxe.make_oxe_dataset_kwargs_and_weights(
                mix, "/data", load_camera_views=views, load_depth=True)
            got_kw, got_w = t_oxe.make_oxe_dataset_kwargs_and_weights(
                mix, "/data", load_camera_views=views, load_depth=True)
            assert got_w == want_w, mix
            assert [comparable(k) for k in got_kw] == [comparable(k) for k in want_kw], (mix, views)
    for lib in (t_oxe, j_oxe):
        with pytest.raises(ValueError, match="unknown OXE dataset 'no_such_dataset'"):
            lib.make_oxe_dataset_kwargs("no_such_dataset", "/data")


def test_every_transform_has_a_schema_here():
    names = {entry["standardize_fn"].__name__ for entry in j_registry.EXTENDED_REGISTRY.values()}
    assert names == set(SCHEMAS)


@pytest.mark.parametrize("fn_name", sorted(SCHEMAS))
def test_transform_matches_jax(fn_name):
    schema = SCHEMAS[fn_name]
    for seed, t in ((0, T), (1, 4)):
        raw = raw_trajectory(schema, seed, t)
        want = getattr(j_registry, fn_name)(to_tf(raw))
        got = getattr(t_oxe.oxe_registry, fn_name)(raw_trajectory(schema, seed, t))
        assert_outputs_equal(got, want)


def test_navigation_transform_of_one_step_is_empty():
    raw = raw_trajectory(SCHEMAS["gnm"], 2, t=1)
    want = j_registry.gnm(to_tf(raw))
    got = t_oxe.oxe_registry.gnm(raw_trajectory(SCHEMAS["gnm"], 2, t=1))
    assert_outputs_equal(got, want)
    assert got["action"].shape == (0, 2)
