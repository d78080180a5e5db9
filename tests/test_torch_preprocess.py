"""The port's offline RLDS resize (``open_pi_zero_torch/data/preprocess.py``,
``open_pi_zero_torch/scripts/modify_rlds_dataset.py``) against the JAX
package's ``data/preprocess.py`` on the CPU, on a small JPEG dataset that
the JAX package's RLDS writer writes.

The JAX side runs its default path: ``native_io.decode_jpeg``, a host
libjpeg at its default ISLOW IDCT, which must load here (the fixture
asserts it). The port decodes the same frames with its own ISLOW
(``INTEGER_ACCURATE``); TensorFlow's IFAST, which the JAX package falls
back to without the library, would put frames up to some 20 levels apart.

Checked: features.json, dataset_info.json and the shard files' names
equal; every non-image leaf bitwise, episode by episode (the JAX reader's
order depends on its threads); empty frames stay empty; each resized frame
within 1 level of JAX's (the port's Lanczos3 is within 9.2e-5 of TensorFlow's
before rounding), and the JPEG bytes equal wherever the resized frames
are (the count of such frames is printed); the CLI writes the same files
as the function.
"""

import json
import os

import numpy as np
import pytest
import tensorflow as tf

from open_pi_zero_torch.data import preprocess as t_pre
from open_pi_zero_torch.data import rlds as t_rlds
from open_pi_zero_torch.scripts import modify_rlds_dataset
from open_pi_zero_tpu.data import native_io
from open_pi_zero_tpu.data import obs_transforms as j_obs
from open_pi_zero_tpu.data import preprocess as j_pre
from open_pi_zero_tpu.data import rlds as j_rlds

tf.config.set_visible_devices([], "GPU")

H, W = 40, 52
SIZE = (24, 28)


def smooth_image(rng, h=H, w=W):
    y, x = np.mgrid[0:h, 0:w]
    phase = rng.uniform(0, 6, 3)
    img = np.stack([128 + 90 * np.sin(x / 7.0 + p) * np.cos(y / 5.0 - p) for p in phase], -1)
    return np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)


def leaves():
    L = j_rlds.LeafSpec
    return [
        L("steps/observation/image_0", "uint8", (H, W, 3), "image", True, "jpeg"),
        L("steps/observation/image_1", "uint8", (H, W, 3), "image", True, "jpeg"),
        L("steps/observation/state", "float32", (7,), "tensor", True),
        L("steps/observation/counts", "int32", (2,), "tensor", True),
        L("steps/action", "float32", (7,), "tensor", True),
        L("steps/language_instruction", "string", (), "text", True),
        L("steps/is_first", "bool", (), "tensor", True),
        L("episode_metadata/file_path", "string", (), "text", False),
    ]


def episodes(rng, n):
    out = []
    for i in range(n):
        t = int(rng.integers(3, 6))
        wrist = [tf.io.encode_jpeg(smooth_image(rng)).numpy() if k % 2 else b"" for k in range(t)]
        out.append({
            "steps": {
                "observation": {
                    "image_0": [tf.io.encode_jpeg(smooth_image(rng)).numpy() for _ in range(t)],
                    "image_1": wrist,  # padding frames (b"") between real ones
                    "state": rng.normal(size=(t, 7)).astype(np.float32),
                    "counts": rng.integers(-5, 5, (t, 2)).astype(np.int32),
                },
                "action": rng.normal(size=(t, 7)).astype(np.float32),
                "language_instruction": [f"task {i}".encode()] * t,
                "is_first": np.arange(t) == 0,
            },
            "episode_metadata": {"file_path": f"/ep{i}".encode()},
        })
    return out


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    root = tmp_path_factory.mktemp("pre")
    src = str(root / "src")
    rng = np.random.default_rng(0)
    j_rlds.write_rlds_dataset(src, "toy", episodes(rng, 5), leaves(), split="train", shards=2)
    j_rlds.write_rlds_dataset(src, "toy", episodes(rng, 2), leaves(), split="val", shards=1)
    return root, src


@pytest.fixture(scope="module")
def resized(jax_written):
    root, src = jax_written
    assert native_io.load_library() is not None, "the JAX package's default decode needs its native libjpeg"
    j_pre.resize_rlds_dataset(src, str(root / "jax"), SIZE, num_workers=2, episodes_per_shard=2)
    t_pre.resize_rlds_dataset(src, str(root / "port"), SIZE, num_workers=2, episodes_per_shard=2)
    return root, src


def files(d):
    return sorted(os.listdir(d))


def test_specs_and_shards_are_jax_s(resized):
    root, _ = resized
    jax, port = str(root / "jax"), str(root / "port")
    assert files(port) == files(jax)
    assert [f for f in files(port) if "tfrecord" in f] == [
        "toy-train.tfrecord-00000-of-00002", "toy-train.tfrecord-00001-of-00002", "toy-val.tfrecord-00000-of-00001"]
    for name in (t_rlds.FEATURES_FILE, t_rlds.INFO_FILE):
        with open(os.path.join(port, name)) as a, open(os.path.join(jax, name)) as b:
            assert json.load(a) == json.load(b), name
    spec = t_rlds.load_spec(port)
    assert [(l.key, l.shape, l.encoding_format) for l in spec.leaves if l.kind == "image"] == [
        ("steps/observation/image_0", (*SIZE, 3), "jpeg"), ("steps/observation/image_1", (*SIZE, 3), "jpeg")]


@pytest.mark.parametrize("split", ["train", "val"])
def test_leaves_and_frames_are_jax_s(resized, split):
    root, src = resized
    read = [{e["episode_metadata"]["file_path"][0]: t_rlds._flatten(e)
             for e in t_rlds.episode_dataset(str(root / d), split=split)} for d in ("src", "jax", "port")]
    assert read[0].keys() == read[1].keys() == read[2].keys() and read[0]
    same_frames = frames = 0
    for path in read[0]:  # the JAX reader's episode order depends on its threads
        s, j, p = (r[path] for r in read)
        assert j.keys() == p.keys() == s.keys()
        for key in j:
            if key.startswith("steps/observation/image"):
                for src_bytes, want, got in zip(s[key], j[key], p[key]):
                    if not src_bytes:
                        assert want == got == b""
                        continue
                    jax_frame = j_obs.resize_image(tf.convert_to_tensor(native_io.decode_jpeg(src_bytes)), SIZE).numpy()
                    port_frame = t_pre.resize_frame(src_bytes, SIZE)
                    assert np.abs(port_frame.astype(int) - jax_frame).max() <= 1, key
                    frames += 1
                    if np.array_equal(port_frame, jax_frame):
                        assert got == want, key
                        same_frames += 1
            elif j[key].dtype == object:
                assert p[key].tolist() == j[key].tolist() == s[key].tolist(), key
            else:
                assert p[key].dtype == j[key].dtype and np.array_equal(p[key], j[key]), key
    print(f"{split}: {same_frames} of {frames} resized frames equal, their JPEG bytes equal")
    assert same_frames > 0


def test_the_cli_writes_what_the_function_writes(resized, tmp_path):
    root, src = resized
    assert vars(modify_rlds_dataset.parse_args(["--src", "a", "--dst", "b"])) == {
        "src": "a", "dst": "b", "size": (224, 224), "workers": 8, "splits": None}
    out = str(tmp_path / "cli")
    modify_rlds_dataset.main(["--src", src, "--dst", out, "--size", *map(str, SIZE), "--workers", "3",
                              "--splits", "val"])
    assert [f for f in files(out) if "tfrecord" in f] == ["toy-val.tfrecord-00000-of-00001"]
    with open(os.path.join(out, "toy-val.tfrecord-00000-of-00001"), "rb") as a, \
            open(str(root / "port" / "toy-val.tfrecord-00000-of-00001"), "rb") as b:
        assert a.read() == b.read()


def test_streaming_writer_checks_the_episode_count(tmp_path):
    rng = np.random.default_rng(1)
    eps = episodes(rng, 3)
    port_leaves = [t_rlds.LeafSpec(**vars(l)) for l in leaves()]
    with pytest.raises(ValueError, match="4 episodes promised, 3 given"):
        t_rlds.write_rlds_dataset(str(tmp_path / "a"), "toy", iter(eps), port_leaves, num_episodes=4)
    with pytest.raises(ValueError, match="2 episodes promised, more given"):
        t_rlds.write_rlds_dataset(str(tmp_path / "b"), "toy", iter(eps), port_leaves, num_episodes=2)
