"""The port's JPEG codec against the committed fixture of TensorFlow's
encodes and decodes, at both integer IDCTs (``tests/fixtures/jpeg_codec.npz``, written by
``tests/make_jpeg_fixture.py`` where TensorFlow is), and its build. This
file imports neither TensorFlow nor JAX, so it also runs where they are
absent, on the card's host: ``python -m pytest --noconftest
tests/test_torch_jpeg_fixture.py -q`` from the checkout's root
(``chip_smoke.py`` phase 8a makes the same check)."""

import numpy as np

from open_pi_zero_torch.data import jpeg
from open_pi_zero_torch.ops import _build
from make_jpeg_fixture import load as load_fixture, load_accurate  # tests/ is on the path under pytest


def test_codec_matches_the_committed_fixture():
    for name, img, data, decoded, quality, chroma in load_fixture():
        assert jpeg.encode_jpeg(img, quality=quality, chroma_downsampling=chroma) == data, name
        assert np.array_equal(jpeg.decode_jpeg(data), decoded), name


def test_accurate_decode_matches_the_committed_fixture():
    accurate = load_accurate()
    for name, _, data, _, _, _ in load_fixture():
        assert np.array_equal(jpeg.decode_jpeg(data, dct_method="INTEGER_ACCURATE"), accurate[name]), name


def test_the_build_uses_the_host_compiler_and_links_no_library():
    command = _build.compile_command(jpeg.SOURCE, _build.BUILD_DIR / "x.so")
    assert command[-1].endswith("csrc/jpeg_codec.cc")
    assert not any(arg.startswith("-l") for arg in command), command
    assert set(_build.HOST_CXX_FLAGS) <= set(command)
    assert _build.library_path(jpeg.SOURCE).name.startswith("libjpeg_codec-")
