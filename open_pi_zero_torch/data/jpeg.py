"""JPEG decoding and encoding for the data pipeline, through the port's own
host codec ``csrc/jpeg_codec.cc`` (counterpart of the JAX package's
``data/native_io.decode_jpeg`` and of its calls to ``tf.io.decode_jpeg``
and ``tf.io.encode_jpeg``).

The codec needs no libjpeg, PIL, cv2 or TensorFlow. ``ops/_build.py``
compiles it with the host C++ compiler at first use; a failed build
raises with the compiler's output. ``decode_jpeg`` is bit for bit
``tf.io.decode_jpeg`` (fancy upsampling) at either integer
``dct_method``: its default IFAST IDCT, or libjpeg's own default ISLOW
(``INTEGER_ACCURATE``, the JAX package's ``native_io.decode_jpeg``);
``encode_jpeg``'s bytes are ``tf.io.encode_jpeg``'s. The C
side owns its buffers and frees them; this side copies out. Calls go
through ``ctypes.CDLL``, which releases the GIL, so the pipeline's threads
decode in parallel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from open_pi_zero_torch.ops import _build

SOURCE = "jpeg_codec"
_ERROR_BYTES = 256
_U8P = ctypes.POINTER(ctypes.c_uint8)
_EXCEPTIONS = {1: NotImplementedError, 2: ValueError, 3: ValueError, 4: MemoryError}
# tf.io.decode_jpeg's dct_method names -> the codec's IDCT ("" is TensorFlow's
# default, IFAST). TensorFlow's INTEGER_FAST and "" run libjpeg's JDCT_IFAST,
# INTEGER_ACCURATE its JDCT_ISLOW.
DCT_METHODS = {"": 0, "INTEGER_FAST": 0, "INTEGER_ACCURATE": 1}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The codec's library, built (``_build.load`` holds its lock) and
    bound at first use."""
    lib = _build.load(SOURCE)
    lib.opz_jpeg_decode.restype = ctypes.c_int
    lib.opz_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.POINTER(_U8P),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.opz_jpeg_encode.restype = ctypes.c_int
    lib.opz_jpeg_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_int,
    ]
    lib.opz_jpeg_free.restype = None
    lib.opz_jpeg_free.argtypes = [ctypes.c_void_p]
    return lib


def _raise(status: int, message: ctypes.Array) -> None:
    raise _EXCEPTIONS.get(status, RuntimeError)(message.value.decode(errors="replace"))


def decode_jpeg(data: bytes, channels: Optional[int] = None, dct_method: str = "INTEGER_FAST") -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, C], as ``tf.io.decode_jpeg(data,
    channels, dct_method=dct_method)``: ``channels`` None or 0 gives the
    file's own (1 or 3), 1 gray (a colour file's Y), 3 RGB (a gray file's Y
    repeated); ``dct_method`` ``""`` or ``"INTEGER_FAST"`` (TensorFlow's
    default, IFAST) or ``"INTEGER_ACCURATE"`` (ISLOW, libjpeg's default).

    Raises NotImplementedError, naming what, for progressive, lossless,
    arithmetic-coded, 12-bit, 4-component and RGB-coded files, ValueError
    for truncated or corrupt data or another ``dct_method``."""
    channels = channels or 0
    if channels not in (0, 1, 3):
        raise ValueError(f"JPEG decodes to 1 or 3 channels, not {channels}")
    if dct_method not in DCT_METHODS:
        raise ValueError(f"dct_method {dct_method!r} is not one of {sorted(DCT_METHODS)}")
    data = bytes(data)
    lib = library()
    out, h, w, c = _U8P(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    message = ctypes.create_string_buffer(_ERROR_BYTES)
    status = lib.opz_jpeg_decode(data, len(data), channels, DCT_METHODS[dct_method], ctypes.byref(out), ctypes.byref(h),
                                 ctypes.byref(w), ctypes.byref(c), message, _ERROR_BYTES)
    try:
        if status:
            _raise(status, message)
        return np.ctypeslib.as_array(out, shape=(h.value, w.value, c.value)).copy()
    finally:
        lib.opz_jpeg_free(out)


def encode_jpeg(image: np.ndarray, quality: int = 95, chroma_downsampling: bool = True) -> bytes:
    """uint8 [H, W, C] (C = 1 or 3; [H, W] is gray) -> JPEG bytes, those of
    ``tf.io.encode_jpeg(image, quality=quality,
    chroma_downsampling=chroma_downsampling)``: baseline, 4:2:0 (4:4:4
    without chroma downsampling), the standard Huffman tables, JFIF at 300
    dpi."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"JPEG encodes uint8, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    if image.ndim != 3 or image.shape[-1] not in (1, 3):
        raise ValueError(f"JPEG encodes [H, W, 1] or [H, W, 3], got {image.shape}")
    if not 0 <= int(quality) <= 100:
        raise ValueError(f"JPEG quality {quality} is outside [0, 100]")
    image = np.ascontiguousarray(image)
    lib = library()
    out, size = _U8P(), ctypes.c_size_t()
    message = ctypes.create_string_buffer(_ERROR_BYTES)
    h, w, c = image.shape
    status = lib.opz_jpeg_encode(image.ctypes.data, h, w, c, int(quality), int(bool(chroma_downsampling)),
                                 ctypes.byref(out), ctypes.byref(size), message, _ERROR_BYTES)
    try:
        if status:
            _raise(status, message)
        return ctypes.string_at(out, size.value)
    finally:
        lib.opz_jpeg_free(out)
