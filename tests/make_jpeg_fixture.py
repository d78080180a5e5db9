"""Writes ``tests/fixtures/jpeg_codec.npz``: frames, TensorFlow's JPEG
encodes of them and TensorFlow's decodes of those files, so that the port's
codec (``open_pi_zero_torch/data/jpeg.py``) can be held bitwise against
TensorFlow where TensorFlow is absent (the card's machine:
``chip_smoke.py``'s codec check, ``tests/test_torch_jpeg.py::
test_codec_matches_the_committed_fixture``).

Run where TensorFlow is installed: ``python -m tests.make_jpeg_fixture``.

Keys, for each case name: ``frame_<name>`` (uint8 [H, W, C]; a case
that encodes the frame of another names it in ``frame_of_<name>``
instead), ``jpeg_<name>`` (the file's bytes as uint8), ``decoded_<name>``
(uint8 [H, W, C], ``tf.io.decode_jpeg`` at its default),
``decoded_accurate_<name>`` (the same with ``dct_method=
"INTEGER_ACCURATE"``, libjpeg's ISLOW IDCT) and ``settings_<name>``
(quality, chroma downsampling).
"""

from __future__ import annotations

import os

import numpy as np

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "jpeg_codec.npz")


def smooth_frame(rng: np.random.Generator, h: int, w: int, c: int) -> np.ndarray:
    """A camera-like frame: smooth gradients and a little noise."""
    y, x = np.mgrid[0:h, 0:w]
    phase = rng.uniform(0, 6, c)
    img = np.stack([128 + 90 * np.sin(x / 11.0 + p) * np.cos(y / 7.0 - p) for p in phase], -1)
    return np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.uint8)


def cases(rng: np.random.Generator):
    """(name, frame or the name of an earlier case's frame, quality,
    chroma_downsampling): the 224² and 256² frames the pipeline decodes
    (4:2:0, quality 95), a 4:4:4 file, a gray file and a small noise frame
    whose edges end inside an MCU."""
    return [
        ("rgb224", smooth_frame(rng, 224, 224, 3), 95, True),
        ("rgb256", smooth_frame(rng, 256, 256, 3), 95, True),
        ("rgb224_444_q75", "rgb224", 75, False),
        ("gray224", smooth_frame(rng, 224, 224, 1), 95, True),
        ("noise37x53", rng.integers(0, 256, (37, 53, 3), dtype=np.uint8), 95, True),
    ]


def load(path: str = PATH):
    """[(name, frame, jpeg bytes, TensorFlow's decode, quality,
    chroma_downsampling)] from the fixture."""
    with np.load(path) as z:
        names = [k[len("jpeg_"):] for k in z.files if k.startswith("jpeg_")]
        out = []
        for name in names:
            source = str(z[f"frame_of_{name}"]) if f"frame_of_{name}" in z.files else name
            quality, chroma = (int(v) for v in z[f"settings_{name}"])
            out.append((name, z[f"frame_{source}"], z[f"jpeg_{name}"].tobytes(), z[f"decoded_{name}"],
                        quality, bool(chroma)))
    return out


def load_accurate(path: str = PATH) -> dict:
    """{name: TensorFlow's ``INTEGER_ACCURATE`` decode} from the fixture."""
    with np.load(path) as z:
        return {k[len("decoded_accurate_"):]: z[k] for k in z.files if k.startswith("decoded_accurate_")}


def main() -> None:
    import tensorflow as tf

    tf.config.set_visible_devices([], "GPU")
    arrays = {}
    for name, frame, quality, chroma in cases(np.random.default_rng(0)):
        if isinstance(frame, str):
            arrays[f"frame_of_{name}"] = np.array(frame)
            frame = arrays[f"frame_{frame}"]
        else:
            arrays[f"frame_{name}"] = frame
        data = tf.io.encode_jpeg(frame, quality=quality, chroma_downsampling=chroma).numpy()
        arrays[f"jpeg_{name}"] = np.frombuffer(data, np.uint8)
        arrays[f"decoded_{name}"] = tf.io.decode_jpeg(data).numpy()
        arrays[f"decoded_accurate_{name}"] = tf.io.decode_jpeg(data, dct_method="INTEGER_ACCURATE").numpy()
        arrays[f"settings_{name}"] = np.array([quality, int(chroma)], np.int32)
    np.savez_compressed(PATH, **arrays)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")


if __name__ == "__main__":
    main()
