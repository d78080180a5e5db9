"""The port's TF-free RLDS files (``open_pi_zero_torch/data``: ``tfrecord``,
``tf_example``, ``rlds``, ``images``) against TensorFlow and the JAX
package's ``data/rlds.py`` on the CPU.

Inputs are made with numpy from a seed. Everything here is exact: the
TFRecord framing and masked crc32c byte for byte TensorFlow's; tensors read
from either package's shards bitwise (dtype and values) the other's
reader's, byte strings equal; PNG decoding bitwise ``tf.io.decode_png``,
over all five PNG filter types, and the port's PNGs bitwise through
TensorFlow's decoder."""

import dataclasses
import struct
import zlib

import numpy as np
import pytest
import tensorflow as tf

from open_pi_zero_torch.data import images as t_images
from open_pi_zero_torch.data import rlds as t_rlds
from open_pi_zero_torch.data import tf_example, tfrecord
from open_pi_zero_tpu.data import rlds as j_rlds

tf.config.set_visible_devices([], "GPU")

H, W = 20, 24  # image size of the episodes here


def smooth_image(rng, h=H, w=W, c=3):
    """A camera-like frame: smooth gradients and a little noise."""
    y, x = np.mgrid[0:h, 0:w]
    phase = rng.uniform(0, 6, c)
    img = np.stack([128 + 90 * np.sin(x / 7.0 + p) * np.cos(y / 5.0 - p) for p in phase], -1)
    return np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)


def leaf_specs(module):
    """Every leaf kind the reader restores: float32, float64 (read back as
    float32), int32, uint8, int64, bool, string, a PNG image; in the steps
    and at the top level."""
    L = module.LeafSpec
    return [
        L("steps/observation/image_0", "uint8", (H, W, 3), "image", True, "png"),
        L("steps/observation/state", "float32", (7,), "tensor", True),
        L("steps/observation/counts", "int32", (2,), "tensor", True),
        L("steps/observation/level", "uint8", (), "tensor", True),
        L("steps/action", "float32", (7,), "tensor", True),
        L("steps/reward", "float64", (), "tensor", True),
        L("steps/language_instruction", "string", (), "text", True),
        L("steps/is_first", "bool", (), "tensor", True),
        L("episode_metadata/file_path", "string", (), "text", False),
        L("episode_metadata/episode_id", "int64", (), "tensor", False),
        L("episode_metadata/success", "bool", (), "tensor", False),
    ]


def make_episodes(n=6, seed=0):
    rng = np.random.default_rng(seed)
    episodes = []
    for i in range(n):
        t = int(rng.integers(3, 8))
        episodes.append({
            "steps": {
                "observation": {
                    "image_0": [tf.io.encode_png(smooth_image(rng)).numpy() for _ in range(t)],
                    "state": rng.normal(size=(t, 7)).astype(np.float32),
                    "counts": rng.integers(-2**31, 2**31 - 1, size=(t, 2)).astype(np.int32),
                    "level": rng.integers(0, 256, t).astype(np.uint8),
                },
                "action": rng.normal(size=(t, 7)).astype(np.float32),
                "reward": rng.normal(size=t),
                "language_instruction": [f"task {i}".encode()] * t,
                "is_first": np.asarray([1] + [0] * (t - 1), bool),
            },
            "episode_metadata": {"file_path": f"/data/ep{i}".encode(), "episode_id": i * 10**12 - 7,
                                 "success": bool(i % 2)},
        })
    return episodes


def leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def assert_episodes_equal(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, (key, a.dtype, b.dtype, a.shape, b.shape)
        if a.dtype == object:
            assert list(a.reshape(-1)) == list(b.reshape(-1)), key
        else:
            assert np.array_equal(a, b), key


def by_id(episodes):
    return {int(ep["episode_metadata"]["episode_id"]): ep for ep in episodes}


def as_port_leaves(leaves_):
    return [t_rlds.LeafSpec(**dataclasses.asdict(l)) for l in leaves_]


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_rlds") / "ds")
    eps = make_episodes()
    j_rlds.write_rlds_dataset(d, "toy", eps, leaf_specs(j_rlds), shards=2)
    return d


@pytest.fixture(scope="module")
def port_written(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_rlds") / "ds")
    t_rlds.write_rlds_dataset(d, "toy", make_episodes(), as_port_leaves(leaf_specs(j_rlds)), shards=2)
    return d


SPLITS = ["train[:50%]", "train[1:3]", "train[95%:]"]


def test_crc32c_and_framing_are_tensorflows(tmp_path):
    assert tfrecord.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    rng = np.random.default_rng(1)
    payloads = [b"", b"x", rng.integers(0, 256, 63, np.uint8).tobytes(),
                rng.integers(0, 256, 100_003, np.uint8).tobytes(), rng.integers(0, 256, 2_500_001, np.uint8).tobytes()]
    want, got = tmp_path / "tf.tfrecord", tmp_path / "port.tfrecord"
    with tf.io.TFRecordWriter(str(want)) as w:
        for p in payloads:
            w.write(p)
    with tfrecord.TFRecordWriter(str(got)) as w:
        for p in payloads:
            w.write(p)
    assert got.read_bytes() == want.read_bytes()
    assert list(tfrecord.read_records(str(want))) == payloads


def test_a_corrupt_or_truncated_record_raises_with_file_and_offset(tmp_path):
    path = tmp_path / "x.tfrecord"
    with tfrecord.TFRecordWriter(str(path)) as w:
        w.write(b"first record")
        w.write(b"second record")
    data = bytearray(path.read_bytes())
    second = 8 + 4 + len(b"first record") + 4
    corrupt = data.copy()
    corrupt[second + 12 + 3] ^= 0x01  # one bit of the second payload
    path.write_bytes(bytes(corrupt))
    with pytest.raises(ValueError, match=rf"x\.tfrecord: corrupt record at offset {second}"):
        list(tfrecord.read_records(str(path)))
    with pytest.raises(tf.errors.DataLossError):  # TensorFlow's reader refuses it too
        list(tf.data.TFRecordDataset(str(path)))
    corrupt = data.copy()
    corrupt[second] ^= 0x01  # the second record's length
    path.write_bytes(bytes(corrupt))
    with pytest.raises(ValueError, match=f"corrupt record length at offset {second}"):
        list(tfrecord.read_records(str(path)))
    path.write_bytes(bytes(data[:-3]))
    with pytest.raises(ValueError, match=f"truncated record at offset {second}"):
        list(tfrecord.read_records(str(path)))


def test_example_wire_format_both_ways():
    rng = np.random.default_rng(2)
    ints = np.concatenate([rng.integers(-2**63, 2**63 - 1, 40, dtype=np.int64),
                           np.asarray([0, 1, -1, 127, 128, 2**63 - 1, -2**63], np.int64)])
    floats = rng.normal(size=17).astype(np.float32)
    strings = [b"", b"a", bytes(range(256)) * 3]
    example = tf.train.Example(features=tf.train.Features(feature={
        "i": tf.train.Feature(int64_list=tf.train.Int64List(value=ints)),
        "f": tf.train.Feature(float_list=tf.train.FloatList(value=floats)),
        "s": tf.train.Feature(bytes_list=tf.train.BytesList(value=strings)),
        "e": tf.train.Feature(float_list=tf.train.FloatList(value=[])),
    }))
    got = tf_example.parse_example(example.SerializeToString())
    assert got["i"][0] == "int64" and np.array_equal(got["i"][1], ints)
    assert got["f"][0] == "float" and np.array_equal(got["f"][1], floats)
    assert got["s"] == ("bytes", strings) and got["e"][1].size == 0
    mine = tf_example.serialize_example({"i": ("int64", ints), "f": ("float", floats), "s": ("bytes", strings)})
    parsed = tf.io.parse_single_example(mine, {
        "i": tf.io.VarLenFeature(tf.int64), "f": tf.io.VarLenFeature(tf.float32),
        "s": tf.io.VarLenFeature(tf.string)})
    assert np.array_equal(tf.sparse.to_dense(parsed["i"]).numpy(), ints)
    assert np.array_equal(tf.sparse.to_dense(parsed["f"]).numpy(), floats)
    assert list(tf.sparse.to_dense(parsed["s"]).numpy()) == strings
    # an unpacked int64 list and an unknown field read too
    unpacked = bytes([0x08, 0x05, 0x08, 0xFF, 0x01])  # Int64List: 5, then 255, one field each
    feature = bytes([0x1A, len(unpacked)]) + unpacked + bytes([0x28, 0x07])  # and field 5, varint 7
    entry = bytes([0x0A, 0x01]) + b"k" + bytes([0x12, len(feature)]) + feature
    features = bytes([0x0A, len(entry)]) + entry
    got = tf_example.parse_example(bytes([0x0A, len(features)]) + features)
    assert got["k"][0] == "int64" and got["k"][1].tolist() == [5, 255]


@pytest.mark.parametrize("split", SPLITS)
def test_jax_written_shards_read_as_jax_reads_them(jax_written, split):
    want = list(j_rlds.episode_dataset(jax_written, split).as_numpy_iterator())
    got = list(t_rlds.episode_dataset(jax_written, split))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):  # a sub-split reads in shard order on both sides
        assert_episodes_equal(a, b)


def test_jax_written_shards_whole_split_and_spec(jax_written):
    spec = t_rlds.load_spec(jax_written)
    assert dataclasses.asdict(spec) == dataclasses.asdict(j_rlds.load_spec(jax_written))
    assert spec.splits == {"train": [3, 3]}
    assert t_rlds.shard_files(jax_written, spec, "train") == j_rlds.shard_files(jax_written, spec, "train")
    # the JAX reader interleaves its shards by timing: compare by episode
    want = by_id(j_rlds.episode_dataset(jax_written, "train").as_numpy_iterator())
    got = list(t_rlds.episode_dataset(jax_written, "train"))
    assert [int(ep["episode_metadata"]["episode_id"]) for ep in got] == [i * 10**12 - 7 for i in range(6)]
    for ep in got:
        assert_episodes_equal(ep, want[int(ep["episode_metadata"]["episode_id"])])
    rng = np.random.default_rng(0)
    shuffled = list(t_rlds.episode_dataset(jax_written, "train", shuffle=True, rng=rng))
    assert sorted(by_id(shuffled)) == sorted(want)
    for split in ("train", "train[:50%]", "train[95%:]", "train[1:3]", "val"):
        if split != "val":
            assert t_rlds.parse_split(split, 6) == j_rlds.parse_split(split, 6)
    with pytest.raises(ValueError, match="cannot parse split"):
        t_rlds.parse_split("train[a:b]", 6)


@pytest.mark.parametrize("split", SPLITS + ["train"])
def test_port_written_shards_read_in_jax(port_written, split):
    want = list(t_rlds.episode_dataset(port_written, split))
    got = by_id(j_rlds.episode_dataset(port_written, split).as_numpy_iterator())
    assert len(got) == len(want) > 0
    for ep in want:
        assert_episodes_equal(got[int(ep["episode_metadata"]["episode_id"])], ep)


def filters_used(png: bytes) -> set:
    """The filter types of a PNG's rows."""
    idat = b"".join(body for kind, body in t_images._chunks(png) if kind == b"IDAT")
    height = struct.unpack(">II", next(body for kind, body in t_images._chunks(png) if kind == b"IHDR")[:8])[1]
    return set(np.frombuffer(zlib.decompress(idat), np.uint8).reshape(height, -1)[:, 0].tolist())


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decodes_tensorflows_encoder_bitwise(channels):
    rng = np.random.default_rng(channels)
    seen = set()
    for h, w in ((37, 51), (64, 64), (5, 3)):
        for img in (smooth_image(rng, h, w, channels), rng.integers(0, 256, (h, w, channels), np.uint8),
                    np.zeros((h, w, channels), np.uint8)):
            png = tf.io.encode_png(img).numpy()
            seen |= filters_used(png)
            assert np.array_equal(t_images.decode_png(png), img)
            want = tf.io.decode_image(png, channels=3, expand_animations=False).numpy()
            assert np.array_equal(t_images.decode_image(png, 3), want)
    assert seen == {0, 1, 2, 3, 4}  # None, Sub, Up, Average and Paeth rows all decoded


def test_png_each_filter_type_alone_and_the_ports_encoder():
    rng = np.random.default_rng(5)
    img = smooth_image(rng, 30, 41, 3)
    # rows filtered by one type each, written here: TensorFlow decodes them
    # as the port does
    stride, bpp = img.shape[1] * 3, 3
    x = img.reshape(img.shape[0], stride).astype(np.int32)
    for kind in range(5):
        rows = []
        for r in range(x.shape[0]):
            a = np.concatenate([np.zeros(bpp, np.int32), x[r, :-bpp]])
            b = x[r - 1] if r else np.zeros(stride, np.int32)
            c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
            pred = [0 * a, a, b, (a + b) // 2, t_images._paeth(a, b, c)][kind]
            rows.append(np.concatenate([[kind], (x[r] - pred) & 255]).astype(np.uint8))
        ihdr = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], 8, 2, 0, 0, 0)
        png = (t_images.PNG_SIGNATURE + t_images._chunk(b"IHDR", ihdr)
               + t_images._chunk(b"IDAT", zlib.compress(np.stack(rows).tobytes())) + t_images._chunk(b"IEND", b""))
        assert filters_used(png) == {kind}
        assert np.array_equal(tf.io.decode_png(png).numpy(), img), kind
        assert np.array_equal(t_images.decode_png(png), img), kind
    for c in (1, 3, 4):
        img = smooth_image(rng, 33, 17, c)
        png = t_images.encode_png(img)
        assert filters_used(png) <= {0, 1, 2}
        assert np.array_equal(tf.io.decode_png(png, channels=c).numpy(), img)
        assert np.array_equal(t_images.decode_png(png), img)
    gray_jpeg = tf.io.encode_jpeg(img[..., :1]).numpy()
    for c in (None, 1, 3):
        assert np.array_equal(t_images.decode_image(gray_jpeg, c),
                              tf.io.decode_image(gray_jpeg, channels=c or 0, expand_animations=False).numpy())
    with pytest.raises(ValueError, match="corrupt PNG chunk"):
        t_images.decode_png(png[:40] + bytes([png[40] ^ 1]) + png[41:])
