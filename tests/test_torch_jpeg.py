"""The port's JPEG codec (``open_pi_zero_torch/csrc/jpeg_codec.cc`` through
``open_pi_zero_torch/data/jpeg.py``) against TensorFlow on the CPU.

Inputs are made with numpy from a seed: smooth camera-like frames and
uniform noise, at 1x1, 7x9, 37x53, 224², 256² and 255x257. Files come
from ``tf.io.encode_jpeg`` (gray; RGB at 4:2:0 and 4:4:4; qualities 50,
75, 95 and 100) and from PIL (RGB at 4:2:0, 4:2:2 and 4:4:4; PIL is used
here only as a second writer). Everything is exact: the decoder is bitwise
``tf.io.decode_jpeg``'s default (``dct_method`` INTEGER_FAST, fancy
upsampling) for every ``channels``, and the encoder's bytes are
``tf.io.encode_jpeg``'s at every quality and chroma setting.
``tests/test_torch_jpeg_fixture.py`` holds the codec against a committed
fixture of TensorFlow's output where TensorFlow is absent."""

import io

import numpy as np
import pytest
import tensorflow as tf
from PIL import Image

from open_pi_zero_torch.data import images, jpeg

tf.config.set_visible_devices([], "GPU")

SIZES = [(1, 1), (7, 9), (37, 53), (224, 224), (256, 256), (255, 257)]
QUALITIES = (50, 75, 95, 100)


def frame(kind: str, h: int, w: int, c: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng([seed, h, w, c])
    if kind == "noise":
        return rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    phase = rng.uniform(0, 6, c)
    img = np.stack([128 + 90 * np.sin(x / 9.0 + p) * np.cos(y / 6.0 - p) for p in phase], -1)
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)


def tf_files(img: np.ndarray):
    """(label, bytes) of every TensorFlow writer setting for this frame."""
    for q in QUALITIES:
        for chroma in ((True, False) if img.shape[-1] == 3 else (True,)):
            yield f"tf q{q} {'420' if chroma else '444'}", tf.io.encode_jpeg(
                img, quality=q, chroma_downsampling=chroma).numpy()


def pil_files(img: np.ndarray):
    """(label, bytes) from PIL at 4:4:4, 4:2:2 and 4:2:0."""
    for subsampling, label in ((0, "444"), (1, "422"), (2, "420")):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=90, subsampling=subsampling)
        yield f"pil {label}", buf.getvalue()


def tf_decode(data: bytes, channels: int) -> np.ndarray:
    return tf.io.decode_jpeg(data, channels=channels).numpy()


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["smooth", "noise"])
def test_decoder_is_tensorflows_default_bitwise(kind, size):
    files = list(tf_files(frame(kind, *size, 1)))
    rgb = frame(kind, *size, 3)
    files += [(f"rgb {label}", data) for label, data in [*tf_files(rgb), *pil_files(rgb)]]
    for label, data in files:
        for channels in (0, 1, 3):
            want = tf_decode(data, channels)
            got = jpeg.decode_jpeg(data, channels or None)
            assert got.dtype == np.uint8 and got.shape == want.shape, (label, channels)
            diff = np.abs(got.astype(int) - want).max()
            assert np.array_equal(got, want), f"{label}, channels {channels}: max|diff| {diff}"


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["smooth", "noise"])
def test_encoder_bytes_are_tensorflows(kind, size):
    for c in (1, 3):
        img = frame(kind, *size, c, seed=1)
        assert jpeg.encode_jpeg(img) == tf.io.encode_jpeg(img).numpy(), f"defaults, {c} channels"
        for q in QUALITIES:
            for chroma in (True, False):
                want = tf.io.encode_jpeg(img, quality=q, chroma_downsampling=chroma).numpy()
                got = jpeg.encode_jpeg(img, quality=q, chroma_downsampling=chroma)
                assert got == want, f"{c} channels, quality {q}, chroma downsampling {chroma}"


def test_channel_rules_follow_decode_image():
    rgb, gray = frame("smooth", 37, 53, 3), frame("smooth", 37, 53, 1)
    for img in (rgb, gray):
        data = jpeg.encode_jpeg(img)
        for channels in (None, 0, 1, 3):
            want = tf.io.decode_image(data, channels=channels or 0, expand_animations=False).numpy()
            assert np.array_equal(images.decode_image(data, channels), want), (img.shape, channels)
    assert jpeg.decode_jpeg(jpeg.encode_jpeg(gray)).shape == (37, 53, 1)
    assert jpeg.decode_jpeg(jpeg.encode_jpeg(rgb)).shape == (37, 53, 3)
    assert np.array_equal(jpeg.encode_jpeg(gray[..., 0]), jpeg.encode_jpeg(gray))  # [H, W] is gray
    with pytest.raises(ValueError, match="1 or 3 channels"):
        jpeg.decode_jpeg(jpeg.encode_jpeg(rgb), 4)
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode_jpeg(rgb.astype(np.float32))
    with pytest.raises(ValueError, match="quality"):
        jpeg.encode_jpeg(rgb, quality=101)


def test_refused_and_broken_files_raise():
    img = frame("smooth", 40, 48, 3)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", progressive=True)
    with pytest.raises(NotImplementedError, match="progressive"):
        jpeg.decode_jpeg(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
    with pytest.raises(NotImplementedError, match="4-component"):
        jpeg.decode_jpeg(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", keep_rgb=True)  # an Adobe marker with transform 0
    with pytest.raises(NotImplementedError, match="RGB-coded"):
        jpeg.decode_jpeg(buf.getvalue())
    # the sample precision byte of SOF0 set to 12
    data = bytearray(tf.io.encode_jpeg(img).numpy())
    sof = data.index(b"\xff\xc0")
    data[sof + 4] = 12
    with pytest.raises(NotImplementedError, match="12-bit"):
        jpeg.decode_jpeg(bytes(data))
    data = tf.io.encode_jpeg(img).numpy()
    for cut in (3, 100, len(data) // 2, len(data) - 2):
        with pytest.raises(ValueError, match="truncated"):
            jpeg.decode_jpeg(data[:cut])
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG\r\n\x1a\n")


def test_restart_intervals_and_optimized_tables_decode_bitwise():
    img = frame("noise", 64, 80, 3)
    for options in (dict(restart_marker_blocks=3), dict(restart_marker_rows=1), dict(optimize=True)):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=85, **options)
        data = buf.getvalue()
        for channels in (0, 1, 3):
            assert np.array_equal(jpeg.decode_jpeg(data, channels), tf_decode(data, channels)), options
