"""The port's ISLOW JPEG decode (``decode_jpeg(..., dct_method=
"INTEGER_ACCURATE")``, jidctint.c's inverse DCT in
``open_pi_zero_torch/csrc/jpeg_codec.cc``) against TensorFlow's
``INTEGER_ACCURATE`` decode and the JAX package's ``native_io.decode_jpeg``
(a host libjpeg at its default IDCT), on the CPU.

The native library must load here: without it ``native_io.decode_jpeg``
falls back to TensorFlow's default (IFAST), and the comparison would hold
nothing. Files come from ``tf.io.encode_jpeg`` (4:2:0, 4:4:4 and gray, at
qualities 50-100) for smooth and noise frames made with numpy from a
seed, at sizes that are and are not multiples of 8 and 16, and from the
committed fixture. Everything is exact; the default decode stays
TensorFlow's IFAST on the same files."""

import numpy as np
import pytest
import tensorflow as tf

from open_pi_zero_torch.data import images, jpeg
from open_pi_zero_tpu.data import native_io
from make_jpeg_fixture import load as load_fixture, load_accurate  # tests/ is on the path under pytest

tf.config.set_visible_devices([], "GPU")

SIZES = [(1, 1), (8, 16), (13, 21), (37, 53), (224, 224), (255, 257)]
QUALITIES = (50, 65, 80, 90, 95, 100)


def frame(kind: str, h: int, w: int, c: int) -> np.ndarray:
    rng = np.random.default_rng([7, h, w, c])
    if kind == "noise":
        return rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 5.0 + p) * np.cos(y / 4.0 - p) for p in rng.uniform(0, 6, c)], -1)
    return np.clip(img + rng.normal(0, 5, img.shape), 0, 255).astype(np.uint8)


def files(kind: str, h: int, w: int):
    """(label, bytes) for TensorFlow's 4:2:0 and 4:4:4 colour files and its
    gray file at every quality."""
    rgb, gray = frame(kind, h, w, 3), frame(kind, h, w, 1)
    for q in QUALITIES:
        yield f"420 q{q}", tf.io.encode_jpeg(rgb, quality=q).numpy()
        yield f"444 q{q}", tf.io.encode_jpeg(rgb, quality=q, chroma_downsampling=False).numpy()
        yield f"gray q{q}", tf.io.encode_jpeg(gray, quality=q).numpy()


@pytest.fixture(scope="module")
def libjpeg():
    assert native_io.load_library() is not None, "the JAX package's native libjpeg must load for this comparison"
    return native_io


def assert_same(got: np.ndarray, want: np.ndarray, label: str) -> None:
    assert got.dtype == np.uint8 and got.shape == want.shape, (label, got.shape, want.shape)
    assert np.array_equal(got, want), f"{label}: max|diff| {np.abs(got.astype(int) - want).max()}"


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["smooth", "noise"])
def test_accurate_decode_is_tensorflows_and_libjpegs_bitwise(libjpeg, kind, size):
    for label, data in files(kind, *size):
        for channels in (0, 1, 3):
            want = tf.io.decode_jpeg(data, channels=channels, dct_method="INTEGER_ACCURATE").numpy()
            assert_same(jpeg.decode_jpeg(data, channels or None, "INTEGER_ACCURATE"), want, f"{label} c{channels}")
        assert_same(jpeg.decode_jpeg(data, 3, "INTEGER_ACCURATE"), libjpeg.decode_jpeg(data), f"{label} native")
        fast = tf.io.decode_jpeg(data).numpy()
        assert_same(jpeg.decode_jpeg(data), fast, f"{label} default")
        assert_same(jpeg.decode_jpeg(data, dct_method=""), fast, f"{label} ''")


def test_accurate_decode_matches_the_fixture_and_libjpeg(libjpeg):
    accurate = load_accurate()
    cases = load_fixture()
    assert sorted(accurate) == sorted(c[0] for c in cases)
    differs = 0
    for name, _, data, fast, _, _ in cases:
        got = jpeg.decode_jpeg(data, dct_method="INTEGER_ACCURATE")
        assert_same(got, accurate[name], name)
        assert_same(jpeg.decode_jpeg(data, 3, "INTEGER_ACCURATE"), libjpeg.decode_jpeg(data), f"{name} native")
        differs += not np.array_equal(got, fast)
    assert differs == len(cases)  # the two IDCTs are told apart on every file


def test_dct_method_names_are_tensorflows():
    data = tf.io.encode_jpeg(frame("smooth", 16, 16, 3)).numpy()
    for name in ("INTEGER_FLOAT", "integer_accurate", "ISLOW"):
        with pytest.raises(ValueError, match="dct_method"):
            jpeg.decode_jpeg(data, dct_method=name)
    assert np.array_equal(images.decode_image(data, 3), jpeg.decode_jpeg(data, 3, "INTEGER_FAST"))
    assert np.array_equal(images.decode_image(data, 3, "INTEGER_ACCURATE"),
                          jpeg.decode_jpeg(data, 3, "INTEGER_ACCURATE"))
