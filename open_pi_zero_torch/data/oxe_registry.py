"""The full Open-X-Embodiment registry: per-dataset camera, proprio and
action facts, standardization transforms, and the named training mixes
(counterpart of the JAX package's ``data/oxe_registry.py``; reference
src/data/oxe/oxe_dataset_configs.py:43-517,
oxe_standardization_transforms.py:27-969, oxe_dataset_mixes.py), in numpy.

The registry facts (which keys hold which camera, how grippers are
encoded) are properties of the public OXE datasets. The transforms go
through shared helpers, as the JAX package's do:

  _ee_action        concat(world_vector, rotation_delta, gripper)
  _invert_clip      clip the gripper to [0, 1], then flip (+1 = open)
  _quat_to_euler    xyzw quaternion -> roll, pitch, yaw (the
                    tensorflow_graphics euler.from_quaternion convention)
  _subsample        stride a whole trajectory (a change of rate)

Where the JAX package calls TensorFlow ops, the port has numpy's:
``tf.io.decode_compressed(..., "ZLIB")`` is ``zlib.decompress``,
``tf.io.decode_raw`` is ``np.frombuffer``, ``tf.strings.unicode_encode``
is ``str.encode``, and strings are object arrays of bytes, as the port's
RLDS reader gives them.

Every transform leaves the trajectory in the layout that
``pipeline.make_dataset_from_rlds`` expects: action [T, A] float32 with
the gripper last (+1 = open), observation.proprio [T, P], and optionally
language_instruction. Importing ``data/oxe.py`` merges the table and the
mixes into its REGISTRY, STANDARDIZE_FNS and MIXES (the bottom of this
file).
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import numpy as np

from open_pi_zero_torch.data import oxe
from open_pi_zero_torch.data.oxe import (
    ActionEncoding,
    ProprioEncoding,
    invert_gripper_actions,
    rel2abs_gripper_actions,
)
from open_pi_zero_torch.models.tree import tree_map

_F = np.float32

# --------------------------------------------------------------------------- #
# transform helpers
# --------------------------------------------------------------------------- #


def _cat(parts, axis: int = -1) -> np.ndarray:
    return np.concatenate(parts, axis=axis)


def _ee_action(traj: dict, gripper: np.ndarray) -> np.ndarray:
    """world_vector + rotation_delta + gripper[:, None] column."""
    gripper = np.asarray(gripper)
    if gripper.ndim == 1:
        gripper = gripper[:, None]
    return _cat([traj["action"]["world_vector"], traj["action"]["rotation_delta"], gripper])


def _invert_clip(g: np.ndarray) -> np.ndarray:
    return invert_gripper_actions(np.clip(g, 0, 1))


def _no_proprio(traj: dict) -> np.ndarray:
    return np.zeros((np.shape(traj["action"])[0], 1), _F)


def _blank(shape) -> np.ndarray:
    out = np.empty(shape, object)
    out.fill(b"")
    return out


def _blank_language(traj: dict, key: str = "natural_language_instruction"):
    src = traj["observation"].get(key, traj.get("language_instruction"))
    traj["language_instruction"] = _blank(np.shape(src))


def _take_language(traj: dict):
    traj["language_instruction"] = traj["observation"]["natural_language_instruction"]


def _quat_to_euler(q: np.ndarray) -> np.ndarray:
    """[..., 4] xyzw quaternion -> [..., 3] roll/pitch/yaw (the
    tensorflow_graphics euler.from_quaternion convention)."""
    x, y, z, w = np.moveaxis(np.asarray(q), -1, 0)
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.stack([roll, pitch, yaw], axis=-1)


def _subsample(traj: dict, factor: int) -> dict:
    return tree_map(lambda x: x[::factor], traj)


def _inflate_floats(column: np.ndarray, width: int) -> np.ndarray:
    """[T] zlib-compressed little-endian float32 records -> [T', width]."""
    raw = [np.frombuffer(zlib.decompress(bytes(b)), "<f4") for b in column]
    return np.concatenate(raw).astype(_F).reshape(-1, width)


# --------------------------------------------------------------------------- #
# per-dataset standardization transforms
# --------------------------------------------------------------------------- #


def kuka(traj):
    grip = rel2abs_gripper_actions(traj["action"]["gripper_closedness_action"][:, 0])
    traj["action"] = _ee_action(traj, grip)
    eef = _inflate_floats(traj["observation"]["clip_function_input/base_pose_tool_reached"], 7)
    gw = _inflate_floats(traj["observation"]["gripper_closed"], 1)
    traj["observation"]["proprio"] = _cat([eef, gw])
    _blank_language(traj)
    return traj


def taco_play(traj):
    act = traj["action"]["rel_actions_world"]
    traj["action"] = _cat([act[:, :6], np.clip(act[:, -1:], 0, 1)])
    robs = traj["observation"]["robot_obs"]
    traj["observation"]["proprio"] = _cat([robs[:, :6], robs[:, 7:8]])
    _take_language(traj)
    return traj


def jaco_play(traj):
    grip = rel2abs_gripper_actions(traj["action"]["gripper_closedness_action"][:, 0])
    wv = traj["action"]["world_vector"]
    traj["action"] = _cat([wv, np.zeros_like(wv), grip[:, None]])
    traj["observation"]["proprio"] = traj["observation"]["end_effector_cartesian_pos"]
    _take_language(traj)
    return traj


def berkeley_cable_routing(traj):
    traj["action"] = _ee_action(traj, np.zeros_like(traj["action"]["world_vector"][:, :1]))
    traj["observation"]["proprio"] = traj["observation"]["robot_state"]
    _blank_language(traj)
    return traj


def roboturk(traj):
    grip = _invert_clip(traj["action"]["gripper_closedness_action"])
    traj["action"] = _ee_action(traj, grip)
    traj["observation"]["proprio"] = _no_proprio(traj)
    _blank_language(traj)
    return traj


def nyu_door_opening(traj):
    grip = rel2abs_gripper_actions(traj["action"]["gripper_closedness_action"][:, 0])
    traj["action"] = _ee_action(traj, grip)
    traj["observation"]["proprio"] = _no_proprio(traj)
    _blank_language(traj)
    return traj


def viola(traj):
    grip = _invert_clip(traj["action"]["gripper_closedness_action"][:, None])
    traj["action"] = _ee_action(traj, grip)
    traj["observation"]["proprio"] = _cat(
        [traj["observation"]["joint_states"], traj["observation"]["gripper_states"]])
    _blank_language(traj)
    return traj


def berkeley_autolab_ur5(traj):
    traj["observation"]["depth"] = traj["observation"].pop("image_with_depth")
    grip = rel2abs_gripper_actions(traj["action"]["gripper_closedness_action"])
    traj["action"] = _ee_action(traj, grip)
    traj["observation"]["proprio"] = traj["observation"]["robot_state"][:, 6:14]
    _take_language(traj)
    return traj


def toto(traj):
    traj["action"] = _ee_action(traj, traj["action"]["open_gripper"][:, None].astype(_F))
    traj["observation"]["proprio"] = traj["observation"]["state"]
    _blank_language(traj)
    return traj


def _first_utf8_piece(codepoints: np.ndarray) -> bytes:
    """A row of padded unicode codepoints -> its UTF-8 text up to the
    first NUL."""
    return "".join(map(chr, codepoints)).encode("utf-8").split(b"\x00")[0]


def language_table(traj):
    act = traj["action"]
    traj["action"] = _cat([act, np.zeros_like(act), np.zeros_like(act), np.ones_like(act[:, :1])])
    traj["observation"]["proprio"] = traj["observation"]["effector_translation"]
    # instructions are stored as padded unicode codepoints
    rows = traj["observation"]["instruction"]
    out = np.empty(len(rows), object)
    out[:] = [_first_utf8_piece(row) for row in rows]
    traj["language_instruction"] = out
    return traj


def pusht(traj):
    traj["action"] = _ee_action(traj, traj["action"]["gripper_closedness_action"][:, None])
    traj["observation"]["proprio"] = traj["observation"]["robot_state"]
    _take_language(traj)
    return traj


def stanford_kuka_multimodal(traj):
    traj["observation"]["depth_image"] = traj["observation"]["depth_image"][..., 0]
    act = traj["action"]
    traj["action"] = _cat([act[:, :3], np.zeros_like(act[:, :3]), act[:, -1:]])
    traj["observation"]["proprio"] = _cat(
        [traj["observation"]["ee_position"], traj["observation"]["ee_orientation"]])
    return traj


def nyu_rot(traj):
    traj["action"] = traj["action"][..., :7]
    traj["observation"]["proprio"] = traj["observation"]["state"]
    return traj


def stanford_hydra(traj):
    traj["action"] = _cat([traj["action"][:, :6], invert_gripper_actions(traj["action"][:, -1:])])
    st = traj["observation"]["state"]
    traj["observation"]["proprio"] = _cat([st[:, :3], st[:, 7:10], st[:, -3:-2]])
    traj["language_instruction"] = _blank(np.shape(traj["language_instruction"]))
    return traj


def _invert_clip_last_dim_state_proprio(traj, proprio_slice):
    traj["action"] = _cat([traj["action"][:, :6], _invert_clip(traj["action"][:, -1:])])
    traj["observation"]["proprio"] = traj["observation"]["state"][:, proprio_slice]
    traj["language_instruction"] = _blank(np.shape(traj["language_instruction"]))
    return traj


def austin_buds(traj):
    return _invert_clip_last_dim_state_proprio(traj, slice(None, 8))


def nyu_franka_play(traj):
    traj["observation"]["depth"] = traj["observation"]["depth"][..., 0].astype(_F)
    traj["observation"]["depth_additional_view"] = traj["observation"]["depth_additional_view"][..., 0].astype(_F)
    act = traj["action"]
    traj["action"] = _cat([act[:, -8:-2], np.clip(act[:, -2:-1], 0, 1)])
    traj["observation"]["proprio"] = traj["observation"]["state"][:, -6:]
    traj["language_instruction"] = _blank(np.shape(traj["language_instruction"]))
    return traj


def maniskill(traj):
    traj["observation"]["proprio"] = _cat([traj["observation"]["tcp_pose"], traj["observation"]["state"][:, 7:8]])
    return traj


def furniture_bench(traj):
    act = traj["action"]
    traj["action"] = _cat([act[:, :3], _quat_to_euler(act[:, 3:7]), _invert_clip(act[:, -1:])])
    st = traj["observation"]["state"]
    traj["observation"]["proprio"] = _cat([st[:, :7], st[:, -1:]])
    return traj


def cmu_franka_exploration(traj):
    traj["action"] = traj["action"][..., :-1]
    traj["observation"]["proprio"] = _no_proprio(traj)
    return traj


def ucsd_kitchen(traj):
    traj["action"] = traj["action"][..., :-1]
    traj["observation"]["proprio"] = traj["observation"]["state"][:, :7]
    return traj


def ucsd_pick_place(traj):
    act = traj["action"]
    traj["action"] = _cat([act[:, :3], np.zeros_like(act[:, :3]), act[:, -1:]])
    traj["observation"]["proprio"] = traj["observation"]["state"]
    return traj


def austin_sailor(traj):
    return _invert_clip_last_dim_state_proprio(traj, slice(None))


def austin_sirius(traj):
    return _invert_clip_last_dim_state_proprio(traj, slice(None))


def bc_z(traj):
    traj["action"] = _cat([
        traj["action"]["future/xyz_residual"][:, :3],
        traj["action"]["future/axis_angle_residual"][:, :3],
        invert_gripper_actions(traj["action"]["future/target_close"][:, :1].astype(_F)),
    ])
    traj["observation"]["proprio"] = _cat([
        traj["observation"]["present/xyz"],
        traj["observation"]["present/axis_angle"],
        traj["observation"]["present/sensed_close"],
    ])
    _take_language(traj)
    return traj


def utokyo_pr2(traj):
    traj["action"] = traj["action"][..., :-1]
    traj["observation"]["proprio"] = traj["observation"]["state"]
    return traj


def utokyo_xarm_pick_place(traj):
    return traj


def utokyo_xarm_bimanual(traj):
    traj["action"] = traj["action"][..., -7:]
    traj["observation"]["proprio"] = traj["observation"]["end_effector_pose"]
    return traj


def robo_net(traj):
    act = traj["action"]
    traj["action"] = _cat([act[:, :4], np.zeros_like(act[:, :2]), act[:, -1:]])
    st = traj["observation"]["state"]
    traj["observation"]["proprio"] = _cat([st[:, :4], np.zeros_like(st[:, :2]), st[:, -1:]])
    return traj


def berkeley_mvp(traj):
    traj["observation"]["proprio"] = _cat(
        [traj["observation"]["pose"], traj["observation"]["gripper"].astype(_F)[:, None]])
    traj["action"] = _cat([traj["action"][:, :-1], invert_gripper_actions(traj["action"][:, -1:])], axis=1)
    return traj


def berkeley_rpt(traj):
    # 30 Hz -> 10 Hz, then joint-delta actions recomputed on the subsample
    traj = _subsample(traj, 3)
    traj["observation"]["proprio"] = _cat(
        [traj["observation"]["joint_pos"], traj["observation"]["gripper"].astype(_F)[:, None]])
    jp = traj["observation"]["joint_pos"]
    joint_actions = jp[1:, :7] - jp[:-1, :7]
    out = tree_map(lambda x: x[:-1], traj)
    out["action"] = _cat([joint_actions, invert_gripper_actions(traj["action"][:-1, -1:])], axis=1)
    return out


def kaist_nonprehensile(traj):
    traj["action"] = _cat([traj["action"][:, :6], np.zeros_like(traj["action"][:, :1])])
    traj["observation"]["proprio"] = traj["observation"]["state"][:, -7:]
    return traj


def stanford_mask_vit(traj):
    act = traj["action"]
    traj["action"] = _cat([act[:, :4], np.zeros_like(act[:, :2]), act[:, -1:]])
    eep = traj["observation"]["end_effector_pose"]
    traj["observation"]["proprio"] = _cat([eep[:, :4], np.zeros_like(eep[:, :2]), eep[:, -1:]])
    return traj


def tokyo_lsmo(traj):
    st = traj["observation"]["state"]
    traj["observation"]["proprio"] = _cat([st[:, :6], st[:, -1:]])
    return traj


def dlr_sara_pour(traj):
    traj["observation"]["proprio"] = traj["observation"]["state"]
    return traj


def dlr_sara_grid_clamp(traj):
    traj["observation"]["proprio"] = traj["observation"]["state"][:, :6]
    return traj


def dlr_edan_shared_control(traj):
    traj["action"] = _cat([traj["action"][:, :6], invert_gripper_actions(traj["action"][:, -1:])])
    traj["observation"]["proprio"] = traj["observation"]["state"]
    return traj


def asu_table_top(traj):
    traj["observation"]["proprio"] = _cat([traj["ground_truth_states"]["EE"], traj["observation"]["state"][:, -1:]])
    return traj


def robocook(traj):
    traj["observation"]["proprio"] = traj["observation"]["state"]
    return traj


def imperial_wristcam(traj):
    traj["action"] = traj["action"][..., :-1]
    traj["observation"]["proprio"] = _no_proprio(traj)
    return traj


def iamlab_pick_insert(traj):
    act = traj["action"]
    traj["action"] = _cat([act[:, :3], _quat_to_euler(act[:, 3:7]), act[:, 7:8]])
    st = traj["observation"]["state"]
    traj["observation"]["proprio"] = _cat([st[:, :7], st[:, 7:8]])
    return traj


def uiuc_d3field(traj):
    act = traj["action"]
    traj["action"] = _cat([act, np.zeros_like(act), np.zeros_like(act[:, :1])])
    traj["observation"]["proprio"] = _no_proprio(traj)
    return traj


def utaustin_mutex(traj):
    return _invert_clip_last_dim_state_proprio(traj, slice(None, 8))


def berkeley_fanuc(traj):
    st = traj["observation"]["state"]
    traj["action"] = _cat([traj["action"], invert_gripper_actions(st[:, 6:7])])
    traj["observation"]["proprio"] = _cat([st[:, :6], st[:, 6:7]])
    return traj


def cmu_playing_with_food(traj):
    act = traj["action"]
    traj["action"] = _cat([act[:, :3], _quat_to_euler(act[:, 3:7]), act[:, -1:]])
    traj["observation"]["proprio"] = traj["observation"]["state"]
    return traj


def playfusion(traj):
    traj["action"] = _cat([traj["action"][:, :3], traj["action"][:, -4:]])
    traj["observation"]["proprio"] = traj["observation"]["state"]
    return traj


def cmu_stretch(traj):
    traj["action"] = traj["action"][..., :-1]
    st = traj["observation"]["state"]
    traj["observation"]["proprio"] = _cat([st[:, :3], np.zeros_like(st[:, :3]), st[:, -1:]])
    return traj


def gnm(traj):
    """Navigation: subsample 3x, recompute body-frame XY waypoint actions
    from positions and yaw, rescale by the dataset's step length."""
    if len(traj["action"]) > 1:
        position = traj["observation"]["position"]
        scale = np.linalg.norm(traj["action"][0]) / np.linalg.norm(position[1] - position[0])
        out = _subsample(traj, 3)
        yaw = out["observation"]["yaw"][:, 0]
        pos = out["observation"]["position"]
        cos, sin = np.cos(yaw), np.sin(yaw)
        rot = np.stack([np.stack([cos, -sin], -1), np.stack([sin, cos], -1)], -2)  # [T, 2, 2]
        delta = pos[1:] - pos[:-1]
        action = np.matmul(delta[:, None], rot[:-1])[:, 0] * scale
        out = tree_map(lambda x: x[:-1], out)
        out["action"] = action
    else:
        out = tree_map(lambda x: x[:0], traj)
    out["observation"]["proprio"] = out["observation"]["state"]
    return out


def aloha(traj):
    traj = _subsample(traj, 5)  # 50 Hz -> 10 Hz
    traj["observation"]["proprio"] = traj["observation"]["state"]
    return traj


def fmb(traj):
    traj["observation"]["proprio"] = _cat(
        [traj["observation"]["eef_pose"], traj["observation"]["state_gripper_pose"][..., None]])
    return traj


def dobbe(traj):
    traj["observation"]["proprio"] = traj["observation"]["state"]
    return traj


def roboset(traj):
    traj["observation"]["proprio"] = traj["observation"]["state"]
    traj["action"] = _cat([traj["action"][:, :7], _invert_clip(traj["action"][:, -1:])])
    return traj


def rh20t(traj):
    traj["action"] = _cat([traj["action"]["tcp_base"], traj["action"]["gripper"][:, None].astype(_F)])
    traj["observation"]["proprio"] = _cat(
        [traj["observation"]["tcp_base"], traj["observation"]["gripper_width"][..., None]])
    return traj


def mujoco_manip(traj):
    grip = invert_gripper_actions(traj["action"][:, -1:] / 255)
    traj["action"] = _cat([traj["action"][:, :6], grip])
    return traj


# --------------------------------------------------------------------------- #
# dataset facts table (compact): (primary, secondary, wrist) images,
# optional (primary, secondary, wrist) depths, proprio/action encodings
# --------------------------------------------------------------------------- #

PE, AE = ProprioEncoding, ActionEncoding


def _entry(primary, secondary, wrist, pe, ae, depth=(None, None, None), fn=None):
    return {
        "image_obs_keys": {"primary": primary, "secondary": secondary, "wrist": wrist},
        "depth_obs_keys": {"primary": depth[0], "secondary": depth[1], "wrist": depth[2]},
        "proprio_encoding": pe,
        "action_encoding": ae,
        "standardize_fn": fn,
    }


EXTENDED_REGISTRY: Dict[str, dict] = {
    "kuka": _entry("image", None, None, PE.POS_QUAT, AE.EEF_POS, fn=kuka),
    "taco_play": _entry(
        "rgb_static", None, "rgb_gripper", PE.POS_EULER, AE.EEF_POS,
        depth=("depth_static", None, "depth_gripper"), fn=taco_play,
    ),
    "jaco_play": _entry("image", None, "image_wrist", PE.POS_EULER, AE.EEF_POS, fn=jaco_play),
    "berkeley_cable_routing": _entry(
        "image", "top_image", "wrist45_image", PE.JOINT, AE.EEF_POS,
        fn=berkeley_cable_routing,
    ),
    "roboturk": _entry("front_rgb", None, None, PE.NONE, AE.EEF_POS, fn=roboturk),
    "nyu_door_opening_surprising_effectiveness": _entry(
        None, None, "image", PE.NONE, AE.EEF_POS, fn=nyu_door_opening
    ),
    "viola": _entry(
        "agentview_rgb", None, "eye_in_hand_rgb", PE.JOINT, AE.EEF_POS, fn=viola
    ),
    "berkeley_autolab_ur5": _entry(
        "image", None, "hand_image", PE.POS_QUAT, AE.EEF_POS,
        depth=("depth", None, None), fn=berkeley_autolab_ur5,
    ),
    "toto": _entry("image", None, None, PE.JOINT, AE.EEF_POS, fn=toto),
    "language_table": _entry("rgb", None, None, PE.POS_EULER, AE.EEF_POS, fn=language_table),
    "columbia_cairlab_pusht_real": _entry(
        "image", None, "wrist_image", PE.POS_EULER, AE.EEF_POS, fn=pusht
    ),
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds": _entry(
        "image", None, None, PE.POS_QUAT, AE.EEF_POS,
        depth=("depth_image", None, None), fn=stanford_kuka_multimodal,
    ),
    "nyu_rot_dataset_converted_externally_to_rlds": _entry(
        "image", None, None, PE.POS_EULER, AE.EEF_POS, fn=nyu_rot
    ),
    "stanford_hydra_dataset_converted_externally_to_rlds": _entry(
        "image", None, "wrist_image", PE.POS_EULER, AE.EEF_POS, fn=stanford_hydra
    ),
    "austin_buds_dataset_converted_externally_to_rlds": _entry(
        "image", None, "wrist_image", PE.JOINT, AE.EEF_POS, fn=austin_buds
    ),
    "nyu_franka_play_dataset_converted_externally_to_rlds": _entry(
        "image", "image_additional_view", None, PE.POS_EULER, AE.EEF_POS,
        depth=("depth", "depth_additional_view", None), fn=nyu_franka_play,
    ),
    "maniskill_dataset_converted_externally_to_rlds": _entry(
        "image", None, "wrist_image", PE.POS_QUAT, AE.EEF_POS,
        depth=("depth", None, "wrist_depth"), fn=maniskill,
    ),
    "furniture_bench_dataset_converted_externally_to_rlds": _entry(
        "image", None, "wrist_image", PE.POS_QUAT, AE.EEF_POS, fn=furniture_bench
    ),
    "cmu_franka_exploration_dataset_converted_externally_to_rlds": _entry(
        "highres_image", None, None, PE.NONE, AE.EEF_POS, fn=cmu_franka_exploration
    ),
    "ucsd_kitchen_dataset_converted_externally_to_rlds": _entry(
        "image", None, None, PE.JOINT, AE.EEF_POS, fn=ucsd_kitchen
    ),
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds": _entry(
        "image", None, None, PE.POS_EULER, AE.EEF_POS, fn=ucsd_pick_place
    ),
    "austin_sailor_dataset_converted_externally_to_rlds": _entry(
        "image", None, "wrist_image", PE.POS_QUAT, AE.EEF_POS, fn=austin_sailor
    ),
    "austin_sirius_dataset_converted_externally_to_rlds": _entry(
        "image", None, "wrist_image", PE.POS_QUAT, AE.EEF_POS, fn=austin_sirius
    ),
    "bc_z": _entry("image", None, None, PE.POS_EULER, AE.EEF_POS, fn=bc_z),
    "utokyo_pr2_opening_fridge_converted_externally_to_rlds": _entry(
        "image", None, None, PE.POS_EULER, AE.EEF_POS, fn=utokyo_pr2
    ),
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds": _entry(
        "image", None, None, PE.POS_EULER, AE.EEF_POS, fn=utokyo_pr2
    ),
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds": _entry(
        "image", "image2", "hand_image", PE.POS_EULER, AE.EEF_POS,
        fn=utokyo_xarm_pick_place,
    ),
    "utokyo_xarm_bimanual_converted_externally_to_rlds": _entry(
        "image", None, None, PE.POS_EULER, AE.EEF_POS, fn=utokyo_xarm_bimanual
    ),
    "robo_net": _entry("image", "image1", None, PE.POS_EULER, AE.EEF_POS, fn=robo_net),
    "berkeley_mvp_converted_externally_to_rlds": _entry(
        None, None, "hand_image", PE.POS_QUAT, AE.JOINT_POS, fn=berkeley_mvp
    ),
    "berkeley_rpt_converted_externally_to_rlds": _entry(
        None, None, "hand_image", PE.JOINT, AE.JOINT_POS, fn=berkeley_rpt
    ),
    "kaist_nonprehensile_converted_externally_to_rlds": _entry(
        "image", None, None, PE.POS_QUAT, AE.EEF_POS, fn=kaist_nonprehensile
    ),
    "stanford_mask_vit_converted_externally_to_rlds": _entry(
        "image", None, None, PE.POS_EULER, AE.EEF_POS, fn=stanford_mask_vit
    ),
    "tokyo_u_lsmo_converted_externally_to_rlds": _entry(
        "image", None, None, PE.POS_EULER, AE.EEF_POS, fn=tokyo_lsmo
    ),
    "dlr_sara_pour_converted_externally_to_rlds": _entry(
        "image", None, None, PE.POS_EULER, AE.EEF_POS, fn=dlr_sara_pour
    ),
    "dlr_sara_grid_clamp_converted_externally_to_rlds": _entry(
        "image", None, None, PE.POS_EULER, AE.EEF_POS, fn=dlr_sara_grid_clamp
    ),
    "dlr_edan_shared_control_converted_externally_to_rlds": _entry(
        "image", None, None, PE.POS_EULER, AE.EEF_POS, fn=dlr_edan_shared_control
    ),
    "asu_table_top_converted_externally_to_rlds": _entry(
        "image", None, None, PE.POS_EULER, AE.EEF_POS, fn=asu_table_top
    ),
    "stanford_robocook_converted_externally_to_rlds": _entry(
        "image_1", "image_2", None, PE.POS_EULER, AE.EEF_POS,
        depth=("depth_1", "depth_2", None), fn=robocook,
    ),
    "imperialcollege_sawyer_wrist_cam": _entry(
        "image", None, "wrist_image", PE.NONE, AE.EEF_POS, fn=imperial_wristcam
    ),
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds": _entry(
        "image", None, "wrist_image", PE.JOINT, AE.EEF_POS, fn=iamlab_pick_insert
    ),
    "uiuc_d3field": _entry(
        "image_1", "image_2", None, PE.NONE, AE.EEF_POS,
        depth=("depth_1", "depth_2", None), fn=uiuc_d3field,
    ),
    "utaustin_mutex": _entry(
        "image", None, "wrist_image", PE.JOINT, AE.EEF_POS, fn=utaustin_mutex
    ),
    "berkeley_fanuc_manipulation": _entry(
        "image", None, "wrist_image", PE.JOINT, AE.EEF_POS, fn=berkeley_fanuc
    ),
    "cmu_playing_with_food": _entry(
        "image", None, "finger_vision_1", PE.POS_EULER, AE.EEF_POS,
        fn=cmu_playing_with_food,
    ),
    "cmu_play_fusion": _entry("image", None, None, PE.JOINT, AE.EEF_POS, fn=playfusion),
    "cmu_stretch": _entry("image", None, None, PE.POS_EULER, AE.EEF_POS, fn=cmu_stretch),
    "gnm_dataset": _entry("image", None, None, PE.POS_NAV, AE.NAV_2D, fn=gnm),
    "aloha_static_dataset": _entry(
        "cam_high", "cam_low", "cam_right_wrist", PE.JOINT_BIMANUAL,
        AE.JOINT_POS_BIMANUAL, fn=aloha,
    ),
    "aloha_dagger_dataset": _entry(
        "cam_high", "cam_low", "cam_right_wrist", PE.JOINT_BIMANUAL,
        AE.JOINT_POS_BIMANUAL, fn=aloha,
    ),
    "aloha_mobile_dataset": _entry(
        "cam_high", None, "cam_right_wrist", PE.JOINT_BIMANUAL,
        AE.JOINT_POS_BIMANUAL_NAV, fn=aloha,
    ),
    "fmb_dataset": _entry(
        "image_side_1", "image_side_2", "image_wrist_1", PE.POS_EULER, AE.EEF_POS,
        depth=("image_side_1_depth", "image_side_2_depth", "image_wrist_1_depth"),
        fn=fmb,
    ),
    "dobbe": _entry(None, None, "wrist_image", PE.POS_EULER, AE.EEF_POS, fn=dobbe),
    "roboset": _entry(
        "image_left", "image_right", "image_wrist", PE.JOINT, AE.JOINT_POS, fn=roboset
    ),
    "rh20t": _entry(
        "image_front", "image_side_right", "image_wrist", PE.POS_EULER, AE.EEF_POS,
        fn=rh20t,
    ),
    "mujoco_manip": _entry("image", None, None, PE.POS_EULER, AE.EEF_POS, fn=mujoco_manip),
}


# --------------------------------------------------------------------------- #
# named mixes (reference oxe_dataset_mixes.py — weights are part of the
# published recipes)
# --------------------------------------------------------------------------- #

RT_X_MIX: List[Tuple[str, float]] = [
    ("fractal20220817_data", 0.54087122203),
    ("kuka", 0.8341046294),
    ("bridge_dataset", 1.0),
    ("taco_play", 2.0),
    ("jaco_play", 2.0),
    ("berkeley_cable_routing", 3.0),
    ("roboturk", 1.0),
    ("nyu_door_opening_surprising_effectiveness", 5.0),
    ("viola", 2.0),
    ("berkeley_autolab_ur5", 1.0),
    ("toto", 1.0),
]

OXE_FRANKA_MIX: List[Tuple[str, float]] = [
    ("taco_play", 1.0),
    ("berkeley_cable_routing", 1.0),
    ("viola", 1.0),
    ("toto", 1.0),
    ("stanford_hydra_dataset_converted_externally_to_rlds", 1.0),
    ("austin_buds_dataset_converted_externally_to_rlds", 3.0),
    ("nyu_franka_play_dataset_converted_externally_to_rlds", 3.0),
    ("maniskill_dataset_converted_externally_to_rlds", 0.1),
    ("furniture_bench_dataset_converted_externally_to_rlds", 0.1),
    ("cmu_franka_exploration_dataset_converted_externally_to_rlds", 5.0),
    ("austin_sailor_dataset_converted_externally_to_rlds", 1.0),
    ("austin_sirius_dataset_converted_externally_to_rlds", 1.0),
    ("berkeley_rpt_converted_externally_to_rlds", 1.0),
    ("kaist_nonprehensile_converted_externally_to_rlds", 3.0),
    ("stanford_robocook_converted_externally_to_rlds", 1.0),
    ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
    ("utaustin_mutex", 1.0),
    ("cmu_play_fusion", 1.0),
]

OXE_MAGIC_SOUP: List[Tuple[str, float]] = [
    ("fractal20220817_data", 0.54087122203),
    ("kuka", 0.8341046294),
    ("bridge_dataset", 1.0),
    ("taco_play", 2.0),
    ("jaco_play", 1.0),
    ("berkeley_cable_routing", 1.0),
    ("roboturk", 2.0),
    ("nyu_door_opening_surprising_effectiveness", 1.0),
    ("viola", 2.0),
    ("berkeley_autolab_ur5", 2.0),
    ("toto", 1.0),
    ("language_table", 0.1),
    ("stanford_hydra_dataset_converted_externally_to_rlds", 2.0),
    ("austin_buds_dataset_converted_externally_to_rlds", 1.0),
    ("nyu_franka_play_dataset_converted_externally_to_rlds", 3.0),
    ("furniture_bench_dataset_converted_externally_to_rlds", 0.1),
    ("ucsd_kitchen_dataset_converted_externally_to_rlds", 2.0),
    ("austin_sailor_dataset_converted_externally_to_rlds", 1.0),
    ("austin_sirius_dataset_converted_externally_to_rlds", 1.0),
    ("bc_z", 0.2),
    ("dlr_edan_shared_control_converted_externally_to_rlds", 1.0),
    ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
    ("utaustin_mutex", 1.0),
    ("berkeley_fanuc_manipulation", 2.0),
    ("cmu_stretch", 1.0),
]

OXE_FLEX_ACT_SOUP: List[Tuple[str, float]] = OXE_MAGIC_SOUP[:19] + [
    ("bc_z", 0.2),
    ("berkeley_mvp_converted_externally_to_rlds", 1.0),
    ("dlr_edan_shared_control_converted_externally_to_rlds", 1.0),
    ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
    ("utaustin_mutex", 1.0),
    ("berkeley_fanuc_manipulation", 2.0),
    ("cmu_stretch", 1.0),
    ("gnm_dataset", 1.0),
    ("aloha_static_dataset", 3.0),
    ("aloha_mobile_dataset", 2.0),
    ("dobbe", 1.0),
    ("roboset", 0.5),
    ("rh20t", 0.5),
]

OXE_FULL_MIX: List[Tuple[str, float]] = [
    (name, 1.0)
    for name in [
        "fractal20220817_data", "kuka", "bridge_dataset", "taco_play", "jaco_play",
        "berkeley_cable_routing", "roboturk",
        "nyu_door_opening_surprising_effectiveness", "viola",
        "berkeley_autolab_ur5", "toto", "language_table",
        "columbia_cairlab_pusht_real",
        "stanford_kuka_multimodal_dataset_converted_externally_to_rlds",
        "nyu_rot_dataset_converted_externally_to_rlds",
        "stanford_hydra_dataset_converted_externally_to_rlds",
        "austin_buds_dataset_converted_externally_to_rlds",
        "nyu_franka_play_dataset_converted_externally_to_rlds",
        "maniskill_dataset_converted_externally_to_rlds",
        "furniture_bench_dataset_converted_externally_to_rlds",
        "cmu_franka_exploration_dataset_converted_externally_to_rlds",
        "ucsd_kitchen_dataset_converted_externally_to_rlds",
        "ucsd_pick_and_place_dataset_converted_externally_to_rlds",
        "austin_sailor_dataset_converted_externally_to_rlds",
        "austin_sirius_dataset_converted_externally_to_rlds", "bc_z",
        "utokyo_pr2_opening_fridge_converted_externally_to_rlds",
        "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds",
        "utokyo_xarm_pick_and_place_converted_externally_to_rlds",
        "utokyo_xarm_bimanual_converted_externally_to_rlds", "robo_net",
        "berkeley_mvp_converted_externally_to_rlds",
        "berkeley_rpt_converted_externally_to_rlds",
        "kaist_nonprehensile_converted_externally_to_rlds",
        "stanford_mask_vit_converted_externally_to_rlds",
        "tokyo_u_lsmo_converted_externally_to_rlds",
        "dlr_sara_pour_converted_externally_to_rlds",
        "dlr_sara_grid_clamp_converted_externally_to_rlds",
        "dlr_edan_shared_control_converted_externally_to_rlds",
        "asu_table_top_converted_externally_to_rlds",
        "stanford_robocook_converted_externally_to_rlds",
        "imperialcollege_sawyer_wrist_cam",
        "iamlab_cmu_pickup_insert_converted_externally_to_rlds", "uiuc_d3field",
        "utaustin_mutex", "berkeley_fanuc_manipulation", "cmu_playing_with_food",
        "cmu_play_fusion", "cmu_stretch", "gnm_dataset",
    ]
]

EXTENDED_MIXES: Dict[str, List[Tuple[str, float]]] = {
    "rtx": RT_X_MIX,
    "rtx_franka": RT_X_MIX + OXE_FRANKA_MIX,
    "oxe_franka": OXE_FRANKA_MIX,
    "oxe_magic_soup": OXE_MAGIC_SOUP,
    "oxe_flex_act_soup": OXE_FLEX_ACT_SOUP,
    "oxe_full": OXE_FULL_MIX,
}

# Merged here rather than in data/oxe.py, so that either module may be
# imported first: data/oxe.py imports this one at its end.
oxe.REGISTRY.update(EXTENDED_REGISTRY)
oxe.MIXES.update(EXTENDED_MIXES)
for _name, _entry in EXTENDED_REGISTRY.items():
    if _entry.get("standardize_fn") is not None:
        oxe.STANDARDIZE_FNS[_name] = _entry["standardize_fn"]
