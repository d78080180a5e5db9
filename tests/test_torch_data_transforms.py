"""The port's trajectory and frame transforms (``open_pi_zero_torch/data``:
``obs_transforms``, ``oxe``, ``traj_transforms``, ``normalization``,
``goal_relabeling``, ``task_augmentation``) against the JAX package's
``tf.data`` transforms and TensorFlow's image ops, on the CPU, on inputs
made with numpy from a seed.

Tolerances:
  - the resize: TensorFlow's float output before rounding within
    RESIZE_FLOAT_TOL = 1e-4 x 255 (the same weights, the sums in another
    order); after rounding at most one level apart, on at most
    RESIZE_ROUNDED_SHARE = 1e-3 of the values;
  - the augment ops at fixed parameters within 1e-5 of TensorFlow's;
  - the trajectory transforms, the gripper ops and normalize_traj bitwise
    (the same float32 arithmetic); the statistics within 1e-12 relative
    (float64 sums);
  - the random parameters' laws: means and ranges over many draws within
    4 standard errors.
"""

import numpy as np
import pytest
import tensorflow as tf

from open_pi_zero_torch.data import goal_relabeling as t_goal
from open_pi_zero_torch.data import normalization as t_norm
from open_pi_zero_torch.data import obs_transforms as t_obs
from open_pi_zero_torch.data import oxe as t_oxe
from open_pi_zero_torch.data import pipeline as t_pipeline
from open_pi_zero_torch.data import task_augmentation as t_task
from open_pi_zero_torch.data import traj_transforms as t_traj
from open_pi_zero_torch.agents.dataset import PRIMARY_AUGMENT_KWARGS
from open_pi_zero_tpu.data import goal_relabeling as j_goal
from open_pi_zero_tpu.data import normalization as j_norm
from open_pi_zero_tpu.data import obs_transforms as j_obs
from open_pi_zero_tpu.data import oxe as j_oxe
from open_pi_zero_tpu.data import pipeline as j_pipeline
from open_pi_zero_tpu.data import traj_transforms as j_traj

tf.config.set_visible_devices([], "GPU")

RESIZE_FLOAT_TOL = 1e-4 * 255
RESIZE_ROUNDED_SHARE = 1e-3


def camera_frame(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    phase = rng.uniform(0, 6, 3)
    img = np.stack([128 + 100 * np.sin(x / 13.0 + p) * np.cos(y / 9.0 - p) for p in phase], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.numpy() if hasattr(tree, "numpy") else np.asarray(tree)


def to_tf(tree):
    if isinstance(tree, dict):
        return {k: to_tf(v) for k, v in tree.items()}
    return tf.constant(tree)


def assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    a, b = np.asarray(got), np.asarray(want)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if b.dtype == object:
        assert list(a.reshape(-1)) == list(b.reshape(-1)), path
    else:
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        assert np.array_equal(a, b), path


def strings(values):
    out = np.empty(len(values), object)
    out[:] = list(values)
    return out


# --------------------------------------------------------------------------- #
# images
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shape", [(224, 224), (256, 256), (256, 320), (112, 112)])
def test_resize_matches_tensorflows_lanczos3(shape):
    img = camera_frame(np.random.default_rng(shape[1]), *shape)
    want = tf.image.resize(tf.cast(img, tf.float32), (224, 224), method="lanczos3", antialias=True).numpy()
    got = t_obs.resize_float(img, (224, 224))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= RESIZE_FLOAT_TOL
    rounded, want_rounded = t_obs.resize_image(img, (224, 224)), j_obs.resize_image(img, (224, 224)).numpy()
    diff = np.abs(rounded.astype(int) - want_rounded.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= RESIZE_ROUNDED_SHARE


def test_padding_image_and_decode_resize():
    rng = np.random.default_rng(3)
    img = camera_frame(rng, 40, 52)
    png = tf.io.encode_png(img).numpy()
    want = j_obs.maybe_decode_and_resize(tf.constant(png), (32, 32)).numpy()
    got = t_obs.maybe_decode_and_resize(png, (32, 32))
    assert got.dtype == np.uint8 and np.abs(got.astype(int) - want).max() <= 1
    assert np.array_equal(t_obs.maybe_decode_and_resize(b"", (32, 32)), np.zeros((32, 32, 3), np.uint8))
    with pytest.raises(ValueError, match="target size"):
        t_obs.maybe_decode_and_resize(b"", None)


@pytest.mark.parametrize("op,param,tf_op", [
    ("random_brightness", 0.07, tf.image.adjust_brightness),
    ("random_brightness", -0.1, tf.image.adjust_brightness),
    ("random_contrast", 0.9, tf.image.adjust_contrast),
    ("random_contrast", 1.1, tf.image.adjust_contrast),
    ("random_saturation", 0.9, tf.image.adjust_saturation),
    ("random_saturation", 1.1, tf.image.adjust_saturation),
    ("random_hue", 0.05, tf.image.adjust_hue),
    ("random_hue", -0.05, tf.image.adjust_hue),
])
def test_augment_op_at_fixed_parameters_matches_tensorflow(op, param, tf_op):
    rng = np.random.default_rng(7)
    x = (camera_frame(rng, 40, 36).astype(np.float32) / 255.0)
    x[:4, :4] = 0.5  # gray pixels: hue and saturation of an equal-channel pixel
    x[4:8, :4] = [0.2, 0.2, 0.7]  # two equal channels
    got = t_obs._APPLY[op](x, np.float32(param))
    np.testing.assert_allclose(got, tf_op(x, param).numpy(), rtol=0, atol=1e-5)


def test_crop_and_resize_and_the_augment_chain_match_tensorflow():
    rng = np.random.default_rng(8)
    img = camera_frame(rng, 64, 64)
    x = img.astype(np.float32) / 255.0
    y0, x0, h, w = 3, 5, 57, 55
    want = tf.image.resize(tf.image.crop_to_bounding_box(x, y0, x0, h, w), (64, 64), method="lanczos3",
                           antialias=True).numpy()
    np.testing.assert_allclose(t_obs.crop_and_resize(x, y0, x0, h, w), want, rtol=0, atol=1e-5)
    # the whole chain at fixed parameters, in the recipe's order, clipped
    # after each op, against the same TensorFlow ops
    params = [("random_resized_crop", (y0, x0, h, w)), ("random_brightness", np.float32(0.05)),
              ("random_contrast", np.float32(1.05)), ("random_saturation", np.float32(0.95)),
              ("random_hue", np.float32(0.03))]
    ref = tf.constant(want)
    ref = tf.clip_by_value(ref, 0.0, 1.0)
    for fn, p in ((tf.image.adjust_brightness, 0.05), (tf.image.adjust_contrast, 1.05),
                  (tf.image.adjust_saturation, 0.95), (tf.image.adjust_hue, 0.03)):
        ref = tf.clip_by_value(fn(ref, p), 0.0, 1.0)
    got = t_obs.augment_image(img, params)
    want_u8 = tf.cast(tf.round(ref * 255.0), tf.uint8).numpy()
    assert got.dtype == np.uint8 and np.abs(got.astype(int) - want_u8).max() <= 1
    assert (got != want_u8).mean() <= RESIZE_ROUNDED_SHARE


def test_augment_parameters_follow_the_recipes_laws():
    n = 2000
    draws = [t_obs.draw_augment_params((224, 224, 3), np.random.default_rng([0, i]), **PRIMARY_AUGMENT_KWARGS)
             for i in range(n)]
    assert [name for name, _ in draws[0]] == PRIMARY_AUGMENT_KWARGS["augment_order"]

    def check_uniform(values, lo, hi):
        values = np.asarray(values, np.float64)
        assert values.min() >= lo and values.max() <= hi
        se = (hi - lo) / np.sqrt(12 * n)
        assert abs(values.mean() - (lo + hi) / 2) <= 4 * se

    params = {name: [d[i][1] for d in draws] for i, (name, _) in enumerate(draws[0])}
    check_uniform(params["random_brightness"], -0.1, 0.1)
    check_uniform(params["random_contrast"], 0.9, 1.1)
    check_uniform(params["random_saturation"], 0.9, 1.1)
    check_uniform(params["random_hue"], -0.05, 0.05)
    crops = np.asarray(params["random_resized_crop"])  # (y0, x0, h, w)
    area = crops[:, 2] * crops[:, 3] / 224**2
    assert area.min() >= 0.78 and area.max() <= 1.0 and 0.88 <= area.mean() <= 0.92
    assert (crops[:, 0] + crops[:, 2] <= 224).all() and (crops[:, 1] + crops[:, 3] <= 224).all()
    ratio = crops[:, 3] / crops[:, 2]
    assert ratio.min() >= 0.88 and ratio.max() <= 1.12
    # the frame's generator decides: the same (seed, index), the same draws
    again = t_obs.draw_augment_params((224, 224, 3), np.random.default_rng([0, 5]), **PRIMARY_AUGMENT_KWARGS)
    assert again == draws[5]


def test_obs_transforms_decode_augment_and_dropout():
    rng = np.random.default_rng(9)
    frames = [camera_frame(rng, 30, 30) for _ in range(2)]
    obs = {"image_primary": strings([tf.io.encode_png(f).numpy() for f in frames]),
           "image_wrist": strings([b"", b""]),
           "pad_mask_dict": {"image_primary": np.ones(2, bool), "image_wrist": np.zeros(2, bool)}}
    frame = {"observation": obs}
    out = t_obs.apply_obs_transforms(frame, np.random.default_rng(0), {"primary": (24, 24), "wrist": (24, 24)},
                                     image_augment_kwargs={"primary": PRIMARY_AUGMENT_KWARGS}, train=True)
    assert out["observation"]["image_primary"].shape == (2, 24, 24, 3)
    assert not out["observation"]["image_wrist"].any()
    # the history's two images took the same crop: a frame resized and
    # augmented twice with one draw gives the same image
    params = t_obs.draw_augment_params((24, 24, 3), np.random.default_rng(0), **PRIMARY_AUGMENT_KWARGS)
    resized = t_obs.resize_image(frames[0], (24, 24))
    assert np.array_equal(out["observation"]["image_primary"][0], t_obs.augment_image(resized, params))
    # dropout: the padding camera is never the one kept; at prob 1 the real one stays
    dropped = t_obs.image_dropout(out["observation"], np.random.default_rng(1), 1.0)
    assert dropped["pad_mask_dict"]["image_primary"].all() and dropped["image_primary"].any()
    two = {"image_a": np.ones((1, 2, 2, 3), np.uint8), "image_b": np.ones((1, 2, 2, 3), np.uint8),
           "pad_mask_dict": {"image_a": np.ones(1, bool), "image_b": np.ones(1, bool)}}
    kept = [t_obs.image_dropout(two, np.random.default_rng(i), 1.0) for i in range(40)]
    assert all(sum(bool(k[n].any()) for n in ("image_a", "image_b")) == 1 for k in kept)
    assert {bool(k["image_a"].any()) for k in kept} == {True, False}
    assert t_obs.image_dropout(two, np.random.default_rng(0), 0.0)["pad_mask_dict"]["image_b"].all()


# --------------------------------------------------------------------------- #
# trajectories
# --------------------------------------------------------------------------- #


def gripper_cases():
    rng = np.random.default_rng(11)
    cases = [rng.choice([0.0, 1.0, 0.5, 0.97, 0.02], size=n).astype(np.float32) for n in (1, 7, 40)]
    cases += [np.full(5, 0.5, np.float32), np.asarray([0.5, 0.5, 1.0, 0.5, 0.3], np.float32)]
    return cases


def test_gripper_ops_equal_jax():
    for actions in gripper_cases():
        got = t_oxe.binarize_gripper_actions(actions)
        assert_trees_equal(got, j_oxe.binarize_gripper_actions(tf.constant(actions)).numpy())
        assert_trees_equal(t_oxe.invert_gripper_actions(actions), j_oxe.invert_gripper_actions(tf.constant(actions)).numpy())
    rng = np.random.default_rng(12)
    for actions in [rng.choice([-1.0, 0.0, 1.0, 0.05], size=n).astype(np.float32) for n in (1, 9, 30)] + [
            np.zeros(6, np.float32), np.asarray([0, 0, 1, 0, -1, 0], np.float32)]:
        assert_trees_equal(t_oxe.rel2abs_gripper_actions(actions),
                           j_oxe.rel2abs_gripper_actions(tf.constant(actions)).numpy())


def bridge_traj(rng, t):
    return {"observation": {"state": rng.normal(size=(t, 7)).astype(np.float32),
                            "image_0": strings([b"img%d" % i for i in range(t)])},
            "action": np.concatenate([rng.normal(size=(t, 6)), rng.choice([0.0, 1.0, 0.5], size=(t, 1))],
                                     1).astype(np.float32),
            "language_instruction": strings([b"put the spoon in the pot"] * t)}


def fractal_traj(rng, t):
    return {"observation": {"base_pose_tool_reached": rng.normal(size=(t, 7)).astype(np.float32),
                            "gripper_closed": rng.uniform(size=(t, 1)).astype(np.float32),
                            "natural_language_instruction": strings([b"pick coke can"] * t),
                            "image": strings([b"x"] * t)},
            "action": {"world_vector": rng.normal(size=(t, 3)).astype(np.float32),
                       "rotation_delta": rng.normal(size=(t, 3)).astype(np.float32),
                       "gripper_closedness_action": rng.choice([-1.0, 0.0, 1.0], size=(t, 1)).astype(np.float32)}}


@pytest.mark.parametrize("name", ["bridge_dataset", "fractal20220817_data"])
def test_standardize_transforms_equal_jax(name):
    rng = np.random.default_rng(13)
    make = bridge_traj if name == "bridge_dataset" else fractal_traj
    traj = make(rng, 9)
    want = to_numpy(j_oxe.STANDARDIZE_FNS[name](to_tf(traj)))
    got = t_oxe.STANDARDIZE_FNS[name](make(np.random.default_rng(13), 9))
    assert_trees_equal(got, want)
    for mix in ("bridge", "fractal", "oxe_simple"):
        t_kw, t_w = t_oxe.make_oxe_dataset_kwargs_and_weights(mix, "/data", load_camera_views=("primary", "wrist"))
        j_kw, j_w = j_oxe.make_oxe_dataset_kwargs_and_weights(mix, "/data", load_camera_views=("primary", "wrist"))
        assert t_w == j_w
        for a, b in zip(t_kw, j_kw):
            assert {k: v for k, v in a.items() if k != "standardize_fn"} == {
                k: v for k, v in b.items() if k != "standardize_fn"}
            assert a["standardize_fn"].__name__ == b["standardize_fn"].__name__
    for lib in (t_oxe, j_oxe):  # a name that neither package registers
        with pytest.raises(ValueError, match="unknown mix 'no_such_mix'"):
            lib.make_oxe_dataset_kwargs_and_weights("no_such_mix", "/data")


def canonical_traj(rng, t, with_timestep=False):
    traj = {"observation": {"image_primary": strings([b"a"] * (t - 1) + [b""]),
                            "proprio": rng.normal(size=(t, 5)).astype(np.float32),
                            "timestep": np.arange(t, dtype=np.int32)},
            "task": {"language_instruction": strings([b"go"] * t)},
            "action": rng.normal(size=(t, 6)).astype(np.float32),
            "dataset_name": strings([b"toy"] * t)}
    if with_timestep:
        traj["task"]["timestep"] = np.minimum(np.arange(t, dtype=np.int32) + 2, t - 1)
    return traj


@pytest.mark.parametrize("window,horizon", [(1, 4), (2, 4)])
@pytest.mark.parametrize("with_timestep", [False, True])
def test_pad_masks_padding_and_chunking_equal_jax(window, horizon, with_timestep):
    def run(lib, traj, wrap):
        traj = lib.add_pad_mask_dict(wrap(traj))
        traj = lib.pad_actions_and_proprio(traj, max_action_dim=8, max_proprio_dim=6)
        return lib.chunk_act_obs(traj, window_size=window, action_horizon=horizon)

    want = to_numpy(run(j_traj, canonical_traj(np.random.default_rng(14), 6, with_timestep), to_tf))
    got = run(t_traj, canonical_traj(np.random.default_rng(14), 6, with_timestep), lambda x: x)
    assert_trees_equal(got, want)
    assert got["action"].shape == (6, window, horizon, 8) and got["action_pad_mask"].shape == (6, window, horizon, 8)
    with pytest.raises(ValueError, match="max_action_dim"):
        t_traj.pad_actions_and_proprio(canonical_traj(np.random.default_rng(0), 3), max_action_dim=4)


def test_filters_subsample_and_flatten():
    rng = np.random.default_rng(15)
    traj = canonical_traj(rng, 12)
    for fn, kw in ((t_traj.within_action_bounds, {"max_action": 1.5}),
                   (t_traj.within_proprio_bounds, {"max_proprio": 10.0})):
        j_fn = getattr(j_traj, fn.__name__)
        assert fn(traj, **kw) == bool(j_fn(to_tf(traj), **kw).numpy())
    assert t_traj.has_language(traj) == bool(j_traj.has_language(to_tf(traj)).numpy()) is True
    unlabeled = canonical_traj(rng, 3)
    unlabeled["task"]["language_instruction"] = strings([b""] * 3)
    assert t_traj.has_language(unlabeled) == bool(j_traj.has_language(to_tf(unlabeled)).numpy()) is False
    sub = t_traj.subsample(dict(traj), 5, np.random.default_rng(0))
    assert sub["action"].shape == (5, 6) and len(set(sub["observation"]["timestep"].tolist())) == 5
    assert t_traj.subsample(dict(traj), 20, np.random.default_rng(0)) is not None
    frames = list(t_traj.flatten_to_frames([canonical_traj(rng, 3), canonical_traj(rng, 2)]))
    assert len(frames) == 5 and frames[4]["observation"]["timestep"] == 1 and frames[0]["dataset_name"] == b"toy"


def test_statistics_and_normalization_equal_jax(tmp_path):
    rng = np.random.default_rng(16)
    trajs = [{"action": rng.normal(size=(t, 7)).astype(np.float32) * 3,
              "observation": {"proprio": rng.normal(size=(t, 5)).astype(np.float32)}} for t in (4, 9, 13)]

    class Listed:  # what the JAX function iterates
        def as_numpy_iterator(self):
            return iter(trajs)

    want, got = j_norm.compute_statistics(Listed()), t_norm.compute_statistics(trajs)
    assert got.keys() == want.keys() and got["num_transitions"] == 26
    for k in ("action", "proprio"):
        for s in want[k]:
            np.testing.assert_allclose(got[k][s], want[k][s], rtol=1e-12, atol=0)
    mask = [True] * 6 + [False]
    for kind in (t_norm.BOUNDS, t_norm.NORMAL):
        traj = {"action": trajs[1]["action"], "observation": {"proprio": trajs[1]["observation"]["proprio"]}}
        out = t_norm.normalize_traj(traj, got, kind, action_mask=mask)
        ref = to_numpy(j_norm.normalize_traj(to_tf(traj), want, kind, action_mask=np.asarray(mask)))
        assert_trees_equal(out, ref)
        assert np.array_equal(out["action"][:, 6], traj["action"][:, 6])  # the masked gripper passes
    with pytest.raises(ValueError, match="unknown normalization"):
        t_norm.normalize_traj(traj, got, "minmax")
    # the cache: written once, read back, the trajectories not iterated again
    cached = t_norm.get_or_compute_statistics(iter(trajs), "/data/x", "fp", cache_dir=str(tmp_path))
    assert t_norm.get_or_compute_statistics(iter(()), "/data/x", "fp", cache_dir=str(tmp_path)) == cached
    assert t_norm.statistics_cache_path("/data/x", "fp", str(tmp_path)).startswith(str(tmp_path))
    x = rng.uniform(-1, 1, size=(3, 7))
    np.testing.assert_array_equal(t_norm.denormalize(x, got["action"], mask=mask),
                                  j_norm.denormalize(x, want["action"], mask=mask))


@pytest.mark.parametrize("n,weights", [(10, [0.5, 0.3, 0.2]), (4, [0.97, 0.01, 0.02]), (None, [1.0])])
def test_allocate_threads_equals_jax(n, weights):
    got = t_pipeline.allocate_threads(n, np.asarray(weights))
    want = j_pipeline.allocate_threads(n, np.asarray(weights))
    assert np.array_equal(got, want) and got.dtype == want.dtype


def test_goal_relabeling_and_task_augmentation():
    rng = np.random.default_rng(17)
    tree_a, tree_b = {"x": 1, "y": {"z": 2, "w": 3}}, {"y": {"z": 5}, "v": 6}
    assert t_goal.tree_merge(tree_a, tree_b) == j_goal.tree_merge(tree_a, tree_b)
    traj = canonical_traj(rng, 10)
    for cap in (None, 3):
        out = t_goal.uniform({**traj, "task": dict(traj["task"])}, max_goal_distance=cap, rng=np.random.default_rng(0))
        goal = out["task"]["timestep"]
        step = np.arange(10)
        hi = np.minimum(step + cap, 10) if cap else np.full(10, 10)
        assert ((goal >= step) & (goal < hi)).all() and out["task"]["language_instruction"][0] == b"go"
    table = {"go": "move.walk"}
    rephraser = t_task.Rephraser(table)
    out = t_task.rephrase_instruction({"task": {"language_instruction": strings([b"go"] * 50)}}, rephraser, 1.0,
                                      np.random.default_rng(1))
    assert set(out["task"]["language_instruction"]) == {b"go", b"move", b"walk"}
    kept = t_task.rephrase_instruction({"task": {"language_instruction": strings([b"go"] * 5)}}, rephraser, 0.0,
                                       np.random.default_rng(1))
    assert list(kept["task"]["language_instruction"]) == [b"go"] * 5
    task = {"language_instruction": strings([b"go"] * 4), "image_goal": np.ones((4, 2, 2, 3), np.uint8),
            "pad_mask_dict": {"language_instruction": np.ones(4, bool), "image_goal": np.ones(4, bool)}}
    out = t_task.delete_task_conditioning({"action": np.zeros((4, 2)), "task": task}, 1.0, np.random.default_rng(2))
    assert out["task"]["image_goal"].all() and list(out["task"]["language_instruction"]) == [b""] * 4
    assert not out["task"]["pad_mask_dict"]["language_instruction"].any()
