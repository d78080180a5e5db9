"""The port's whole data pipeline (``data/pipeline.py``,
``agents/dataset.RLDSInterleavedDataset``) against the JAX package's
``make_interleaved_dataset`` on the CPU, and the TrainAgent trained from
``cfg.data`` through ``scripts/run.py``.

Two small datasets are written by the JAX package's writer with PNG
frames: a bridge-like one (``bridge_dataset``: ``image_0``, 7-dim
``state`` and ``action``, an instruction, one unlabeled episode) and a
fractal-like one (``fractal20220817_data``: the RT-1 keys). With
augmentation off and the frames at their own size, the port yields the
same multiset of frames as JAX: images, proprio, action chunks, every
mask, instructions and dataset names equal, bitwise. (A multiset: the JAX
package's order depends on its threads; so do its statistics' float64
sums, held within 1e-12.) Resized to another size, the
images are within one level of JAX's (the resize's float sums run in
another order; tests/test_torch_data_transforms.py bounds them).

The port's own properties: two ``iterator()`` calls give the same batches,
whatever the thread counts; the frames run numpy's BLAS on one thread, and
the resize's products are bitwise those of the BLAS pool on every core;
the batches have the JAX agent's structure
(keys, dtypes, shapes); ``oxe_simple``'s sampling frequencies match its
transition-balanced weights within 4 binomial standard deviations."""

import collections
import os

import numpy as np
import pytest
import tensorflow as tf
import torch

from open_pi_zero_torch.agents import dataset as t_dataset
from open_pi_zero_torch.config import ConfigDict
from open_pi_zero_torch.data import obs_transforms
from open_pi_zero_torch.data import oxe as t_oxe
from open_pi_zero_torch.data import pipeline as t_pipeline
from open_pi_zero_torch.scripts import run
from open_pi_zero_tpu.agents import dataset as j_dataset
from open_pi_zero_tpu.data import oxe as j_oxe
from open_pi_zero_tpu.data import pipeline as j_pipeline
from open_pi_zero_tpu.data import rlds as j_rlds
from tests.test_torch_train_agent_card import TINY_YAML

tf.config.set_visible_devices([], "GPU")

SIZE = 28  # the frames' size, the tiny geometry's image size


def frame_image(rng):
    y, x = np.mgrid[0:SIZE, 0:SIZE]
    phase = rng.uniform(0, 6, 3)
    img = np.stack([128 + 100 * np.sin(x / 5.0 + p) * np.cos(y / 4.0 - p) for p in phase], -1)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def bridge_episodes(rng, n):
    episodes = []
    for i in range(n):
        t = int(rng.integers(4, 9))
        gripper = rng.choice([0.0, 1.0, 0.5], size=(t, 1))
        episodes.append({"steps": {
            "observation": {"image_0": [tf.io.encode_png(frame_image(rng)).numpy() for _ in range(t)],
                            "state": rng.normal(size=(t, 7)).astype(np.float32)},
            "action": np.concatenate([rng.normal(size=(t, 6)), gripper], 1).astype(np.float32),
            "language_instruction": [b"" if i == 2 else f"bridge task {i}".encode()] * t,
            "is_first": np.asarray([1] + [0] * (t - 1), bool),
        }})
    return episodes


def fractal_episodes(rng, n):
    episodes = []
    for i in range(n):
        t = int(rng.integers(3, 7))
        episodes.append({"steps": {
            "observation": {"image": [tf.io.encode_png(frame_image(rng)).numpy() for _ in range(t)],
                            "base_pose_tool_reached": rng.normal(size=(t, 7)).astype(np.float32),
                            "gripper_closed": rng.uniform(size=(t, 1)).astype(np.float32),
                            "natural_language_instruction": [f"fractal task {i}".encode()] * t},
            "action": {"world_vector": rng.normal(size=(t, 3)).astype(np.float32),
                       "rotation_delta": rng.normal(size=(t, 3)).astype(np.float32),
                       "gripper_closedness_action": rng.choice([-1.0, 0.0, 1.0], size=(t, 1)).astype(np.float32)},
            "is_first": np.asarray([1] + [0] * (t - 1), bool),
        }})
    return episodes


def bridge_leaves(module):
    L = module.LeafSpec
    return [L("steps/observation/image_0", "uint8", (SIZE, SIZE, 3), "image", True, "png"),
            L("steps/observation/state", "float32", (7,), "tensor", True),
            L("steps/action", "float32", (7,), "tensor", True),
            L("steps/language_instruction", "string", (), "text", True),
            L("steps/is_first", "bool", (), "tensor", True)]


def fractal_leaves(module):
    L = module.LeafSpec
    return [L("steps/observation/image", "uint8", (SIZE, SIZE, 3), "image", True, "png"),
            L("steps/observation/base_pose_tool_reached", "float32", (7,), "tensor", True),
            L("steps/observation/gripper_closed", "float32", (1,), "tensor", True),
            L("steps/observation/natural_language_instruction", "string", (), "text", True),
            L("steps/action/world_vector", "float32", (3,), "tensor", True),
            L("steps/action/rotation_delta", "float32", (3,), "tensor", True),
            L("steps/action/gripper_closedness_action", "float32", (1,), "tensor", True),
            L("steps/is_first", "bool", (), "tensor", True)]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("oxe")
    rng = np.random.default_rng(0)
    j_rlds.write_rlds_dataset(str(root / "bridge_dataset"), "bridge_dataset", bridge_episodes(rng, 7),
                              bridge_leaves(j_rlds), shards=2)
    j_rlds.write_rlds_dataset(str(root / "fractal20220817_data"), "fractal20220817_data",
                              fractal_episodes(rng, 5), fractal_leaves(j_rlds), shards=2)
    return str(root)


@pytest.fixture(autouse=True)
def hermetic_cache(tmp_path, monkeypatch):
    """Both packages' statistics caches under this test's directory."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))


def frames_of(lib, oxe_lib, data_dir, mix, size, views=("primary",)):
    kwargs, weights = oxe_lib.make_oxe_dataset_kwargs_and_weights(mix, data_dir, load_camera_views=views)
    ds = lib.make_interleaved_dataset(
        kwargs, weights, train=False, split="train",
        traj_transform_kwargs=dict(window_size=2, action_horizon=4, skip_unlabeled=True),
        frame_transform_kwargs=dict(resize_size={view: (size, size) for view in views}, image_augment_kwargs=None,
                                    num_parallel_calls=3),
    )
    return list(ds.as_numpy_iterator()) if lib is j_pipeline else list(ds), ds


def key(frame):
    return (frame["dataset_name"], frame["task"]["language_instruction"],
            tuple(frame["observation"]["timestep"].tolist()))


def flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


@pytest.mark.parametrize("mix,views", [
    ("bridge", ("primary",)),
    ("oxe_simple", ("primary",)),
    ("bridge", ("primary", "wrist")),  # bridge has no wrist camera: zero padding images, pad masks False
])
def test_frames_are_jax_frames_as_a_multiset(data_dir, mix, views):
    want, j_ds = frames_of(j_pipeline, j_oxe, data_dir, mix, SIZE, views)
    got, t_ds = frames_of(t_pipeline, t_oxe, data_dir, mix, SIZE, views)
    assert len(got) == len(want) > 0
    assert len({key(f) for f in got}) == len(got)
    assert not any(k[1] == b"" for k in map(key, got))  # the unlabeled episode is filtered
    assert t_ds.sample_weights == j_ds.sample_weights
    for a, b in zip(t_ds.dataset_statistics, j_ds.dataset_statistics):
        # float64 sums over the trajectories in another order: 1e-12
        assert a.keys() == b.keys() and a["num_transitions"] == b["num_transitions"]
        for k in ("action", "proprio"):
            for s in b[k]:
                np.testing.assert_allclose(a[k][s], b[k][s], rtol=1e-12, atol=1e-15)
    by_key = {key(f): f for f in want}
    assert sorted(by_key) == sorted(key(f) for f in got)
    if "wrist" in views:
        assert not any(f["observation"]["image_wrist"].any() or f["observation"]["pad_mask_dict"]["image_wrist"].any()
                       for f in got)
    for frame in got:
        a, b = dict(flat(frame)), dict(flat(by_key[key(frame)]))
        assert a.keys() == b.keys()
        for name in b:
            assert a[name].shape == b[name].shape, name
            if b[name].dtype == object or b[name].dtype.kind == "S":
                assert a[name].tolist() == b[name].tolist(), name
            else:
                assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]), name


def test_resized_frames_within_one_level_of_jax(data_dir):
    want, _ = frames_of(j_pipeline, j_oxe, data_dir, "bridge", 24)
    got, _ = frames_of(t_pipeline, t_oxe, data_dir, "bridge", 24)
    by_key = {key(f): f for f in want}
    diffs = [np.abs(f["observation"]["image_primary"].astype(int)
                    - by_key[key(f)]["observation"]["image_primary"].astype(int)).max() for f in got]
    assert len(diffs) == len(want) and max(diffs) <= 1


def data_config(data_dir, **over):
    cfg = dict(dataset_mix="oxe_simple", data_path=data_dir, split="train", window_size=1, action_horizon=4,
               skip_unlabeled=True, load_proprio=True, resize_size=[SIZE, SIZE], shuffle_buffer_size=30,
               num_parallel_calls=3, traj_transform_threads=2, traj_read_threads=2, max_action_dim=7,
               max_proprio_dim=8)
    cfg.update(over)
    return ConfigDict(cfg)


def batches(dataset, n, batch_size=4):
    it = dataset.iterator(batch_size)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def test_iterator_restarts_from_the_seed_whatever_the_threads(data_dir):
    first = batches(t_dataset.RLDSInterleavedDataset(data_config(data_dir), train=True, seed=3), 6)
    again = batches(t_dataset.RLDSInterleavedDataset(
        data_config(data_dir, num_parallel_calls=1, traj_transform_threads=4, traj_read_threads=4),
        train=True, seed=3), 6)
    for a, b in zip(first, again):
        for (name, x), (_, y) in zip(flat(a), flat(b)):
            assert x.dtype == y.dtype and x.tolist() == y.tolist(), name
    other = batches(t_dataset.RLDSInterleavedDataset(data_config(data_dir), train=True, seed=4), 1)[0]
    assert not np.array_equal(other["observation"]["image_primary"], first[0]["observation"]["image_primary"])


@pytest.mark.parametrize("shape,size", [((256, 256, 3), (224, 224)), ((64, 80, 3), (224, 224)),
                                        ((480, 640, 3), (256, 256))])
def test_frames_run_numpy_blas_on_one_thread(data_dir, shape, size):
    """FrameDataset.frames holds numpy's OpenBLAS to one thread (as
    threadpoolctl reads it back); a resize's products under it are bitwise
    those under a pool of every core, so the count changes no frame."""
    import threadpoolctl

    image = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    with threadpoolctl.threadpool_limits(limits=os.cpu_count(), user_api="blas"):
        many = obs_transforms.resize_float(image, size)
        frames = t_dataset.RLDSInterleavedDataset(data_config(data_dir), train=True, seed=0).dataset.frames()
        next(frames)
        pools = [p for p in threadpoolctl.threadpool_info()  # numpy's (scipy has its own)
                 if p["internal_api"] == "openblas" and "numpy" in os.path.basename(os.path.dirname(p["filepath"]))]
        assert pools and all(p["num_threads"] == 1 for p in pools)
        one = obs_transforms.resize_float(image, size)
    assert np.array_equal(many, one)


def test_batches_have_the_jax_agents_structure(data_dir, tmp_path):
    t_batch = batches(t_dataset.RLDSInterleavedDataset(data_config(data_dir), train=True, seed=0), 1)[0]
    j_batch = next(j_dataset.RLDSInterleavedDataset(data_config(data_dir), train=True, seed=0).iterator(4))
    a, b = dict(flat(t_batch)), dict(flat(j_batch))
    assert a.keys() == b.keys()
    for name in b:
        kind = "bytes" if b[name].dtype == object else b[name].dtype
        assert a[name].shape == b[name].shape and ("bytes" if a[name].dtype == object else a[name].dtype) == kind, name
    images = t_batch["observation"]["image_primary"]
    assert images.dtype == np.uint8 and images.shape == (4, 1, SIZE, SIZE, 3)
    assert t_batch["action"].shape == (4, 1, 4, 7) and t_batch["observation"]["proprio"].shape == (4, 1, 8)


def test_iterator_refuses_a_world_of_processes(data_dir, monkeypatch):
    """A world of 2 processes (torchrun's RANK and WORLD_SIZE): process i
    reads every 2nd frame of the stream from i, JAX's ``ds.shard(2, i)``
    before the batch. The shards are disjoint and together are the first
    frames of the whole stream, each frame bitwise as the unsharded
    iterator makes it (its draws come from its index in the stream);
    ``shard_per_process=False`` reads the whole stream."""
    dataset = t_dataset.RLDSInterleavedDataset(data_config(data_dir), train=True)
    whole = [dict(flat(b)) for b in batches(dataset, 4, batch_size=2)]
    monkeypatch.setenv("WORLD_SIZE", "2")
    shards = []
    for rank in (0, 1):
        monkeypatch.setenv("RANK", str(rank))
        shards.append([dict(flat(b)) for b in batches(dataset, 2, batch_size=2)])
    it = dataset.iterator(2, shard_per_process=False)
    try:
        unsharded = dict(flat(next(it)))
    finally:
        it.close()
    for name in whole[0]:
        frames = np.concatenate([b[name] for b in whole])  # frames 0..7 of the stream
        for rank in (0, 1):
            got = np.concatenate([b[name] for b in shards[rank]])
            if frames.dtype == object:
                assert list(got) == list(frames[rank::2]), name
            else:
                np.testing.assert_array_equal(got, frames[rank::2], err_msg=name)
        np.testing.assert_array_equal(unsharded[name], whole[0][name], err_msg=name)


def test_oxe_simple_sampling_follows_the_balanced_weights(data_dir):
    kwargs, weights = t_oxe.make_oxe_dataset_kwargs_and_weights("oxe_simple", data_dir)
    ds = t_pipeline.make_interleaved_dataset(
        kwargs, weights, train=True, shuffle_buffer_size=1, seed=5,
        traj_transform_kwargs=dict(window_size=1, action_horizon=4, skip_unlabeled=True),
    )
    sizes = np.asarray([s["num_transitions"] for s in ds.dataset_statistics], np.float64)
    np.testing.assert_allclose(ds.sample_weights, sizes / sizes.sum(), rtol=1e-12)
    n = 3000
    it = iter(ds)
    counts = collections.Counter(next(it)["dataset_name"] for _ in range(n))
    p = ds.sample_weights[0]
    assert abs(counts[b"bridge_dataset"] - n * p) <= 4 * np.sqrt(n * p * (1 - p))
    assert counts[b"bridge_dataset"] + counts[b"fractal20220817_data"] == n


DATA_BLOCK = """\
data:
  train:
    dataset_mix: bridge
    split: train
    data_path: {data_path}
    window_size: 1
    action_horizon: 4
    skip_unlabeled: true
    load_proprio: true
    resize_size: [28, 28]
    shuffle_buffer_size: 20
    num_parallel_calls: 2
    traj_transform_threads: 1
    traj_read_threads: 1
  val:
    split:
    shuffle_buffer_size: 10
"""


def test_launcher_trains_from_cfg_data(data_dir, tmp_path):
    """configs/train/bridge.yaml's layout at the tiny geometry, its data
    from the bridge-like dataset: scripts/run.py --mode train builds the
    datasets from cfg.data, takes 2 updates (validating at the second) and
    saves ckpt_2."""
    path = tmp_path / "train.yaml"
    path.write_text(TINY_YAML.format(log_dir=tmp_path / "log", quantize="false", lora="false")
                    + DATA_BLOCK.format(data_path=data_dir))
    state = run.main(["--config", str(path), "--mode", "train", "--device", "cpu"])
    assert state.step == 2
    assert os.path.exists(tmp_path / "log" / "checkpoint" / "ckpt_2" / "meta.json")
    assert all(torch.isfinite(x).all() for x in (state.params["embed_tokens"],))


def test_stream_helpers_keep_order_raise_and_stop(monkeypatch):
    """ordered_map under more threads than cores and a short switch
    interval keeps the input order; prefetch hands the producer's exception
    to the consumer, and its thread ends when the consumer closes it."""
    import sys
    import threading
    import time

    from open_pi_zero_torch.data import streams

    delays = np.random.default_rng(0).uniform(0, 2e-3, 400)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = list(streams.prefetch(streams.ordered_map(lambda i: (time.sleep(delays[i]), i * i)[1], range(400),
                                                        4 * (os.cpu_count() or 1)), 3))
    finally:
        sys.setswitchinterval(interval)
    assert out == [i * i for i in range(400)]

    def failing():
        yield 1
        raise OSError("disk gone")

    it = streams.prefetch(failing(), 2)
    assert next(it) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    before = {t for t in threading.enumerate() if t.name == "opz-data-prefetch"}
    it = streams.prefetch(iter(range(10**9)), 2)
    assert next(it) == 0
    it.close()
    alive = [t for t in threading.enumerate() if t.name == "opz-data-prefetch" and t not in before]
    for t in alive:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in alive)
    buffered = list(streams.shuffle_buffer(range(100), 10, np.random.default_rng(0)))
    assert sorted(buffered) == list(range(100)) and buffered != list(range(100))
