"""Image codecs of the data pipeline: a PNG decoder and encoder for 8-bit
images in numpy and the standard library's ``zlib``, and ``decode_image``,
which takes PNG or JPEG (the JAX package decodes with
``tf.io.decode_image``, ``data/obs_transforms.py:15-18``).

The decoder takes 8-bit grayscale, gray + alpha, RGB and RGBA, not
interlaced, and converts to the channels asked for as TensorFlow's
``decode_png`` does: gray is repeated to RGB, alpha is dropped. It undoes
all five PNG filters, since ``tf.io.encode_png`` (libpng) picks a filter
per row: rows filtered None, Sub or Up are undone at once for the whole
image (Sub is a running sum along the row, Up one down the rows); an image
with any Average or Paeth row is undone along anti-diagonals, each of
which depends only on the one before.

The encoder writes only None, Sub and Up rows, choosing per row the filter
with the least sum of absolute signed bytes (libpng's heuristic), so that
the port's own files take the fast path. It deflates at zlib level 1: on
smooth 224² frames a tenth of level 6's time for some 6% more bytes.

JPEG goes through ``data/jpeg.py``, the port's own codec (no libjpeg,
PIL, cv2 or TensorFlow), bit for bit ``tf.io.decode_jpeg``'s default.
Real OXE datasets, the JAX package's demo writers and the port's store
JPEG; PNG stays for datasets that hold it.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from open_pi_zero_torch.data.jpeg import decode_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG color type -> samples per pixel
ZLIB_LEVEL = 1


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"corrupt PNG chunk {kind!r} at offset {pos}")
        yield kind, body
        pos += 12 + length


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_fast(kinds: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Rows filtered None (0), Sub (1) or Up (2), all at once. Sub rows are
    running sums along the row. Up rows add the row above: over the rows, a
    running sum restarted at each row that is not Up."""
    h, stride = rows.shape
    out = rows.copy()
    sub = kinds == 1
    if sub.any():
        out[sub] = np.cumsum(rows[sub].reshape(-1, stride // bpp, bpp), axis=1, dtype=np.uint8).reshape(-1, stride)
    up = kinds == 2
    if up.any():
        total = np.cumsum(out, axis=0, dtype=np.uint8)
        start = np.maximum.accumulate(np.where(up, 0, np.arange(h)))  # the row each run of Up rows adds onto
        before = np.where((start > 0)[:, None], total[np.maximum(start - 1, 0)], 0).astype(np.uint8)
        out = total - before
    return out


def _unfilter_wavefront(kinds: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Any filters, along anti-diagonals r + i = d of (row, pixel): a pixel
    reads its left (a), upper (b) and upper-left (c) neighbours, which lie
    on the two diagonals before its own."""
    h, stride = rows.shape
    w = stride // bpp
    raw = rows.reshape(h, w, bpp).astype(np.int32)
    x = np.zeros((h + 1, w + 1, bpp), np.int32)  # one row and column of zeros before the image
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        i = d - r
        a, b, c = x[r + 1, i], x[r, i + 1], x[r, i]
        kind = kinds[r][:, None]
        pred = np.select(
            [kind == 1, kind == 2, kind == 3, kind == 4],
            [a, b, (a + b) >> 1, _paeth(a, b, c)],
            0,
        )
        x[r + 1, i + 1] = (raw[r, i] + pred) & 255
    return x[1:, 1:].astype(np.uint8).reshape(h, stride)


def decode_png(data: bytes, channels: Optional[int] = None) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C]; ``channels`` 3 gives RGB (gray
    repeated, alpha dropped), 1 a gray image's one channel, None the
    file's own."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise NotImplementedError(
            f"PNG of bit depth {depth}, color type {color}, interlace {interlace}: only 8-bit "
            "gray, gray + alpha, RGB and RGBA without interlace are decoded")
    bpp = _CHANNELS[color]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG data of {raw.size} bytes, want {height * (stride + 1)}")
    raw = raw.reshape(height, stride + 1)
    kinds, rows = raw[:, 0], raw[:, 1:]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    unfilter = _unfilter_fast if kinds.max(initial=0) <= 2 else _unfilter_wavefront
    image = unfilter(kinds, rows, bpp).reshape(height, width, bpp)
    if channels in (None, 0, bpp):
        return image
    gray = bpp <= 2
    if channels == 3:
        return np.repeat(image[..., :1], 3, axis=-1) if gray else np.ascontiguousarray(image[..., :3])
    if channels == 1 and gray:
        return np.ascontiguousarray(image[..., :1])
    raise NotImplementedError(f"PNG with {bpp} channels to {channels}")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(image: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, C] (C = 1, 2, 3 or 4) -> PNG bytes, each row
    filtered None, Sub or Up."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"PNG encodes uint8, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = image.reshape(h, w * c)
    sub = rows.copy()
    sub[:, c:] -= rows[:, :-c]
    up = rows.copy()
    up[1:] -= rows[:-1]
    candidates = np.stack([rows, sub, up])  # [filter, H, stride]
    cost = np.abs(candidates.view(np.int8).astype(np.int32)).sum(-1)
    kinds = cost.argmin(0).astype(np.uint8)
    filtered = candidates[kinds, np.arange(h)]
    scanlines = np.concatenate([kinds[:, None], filtered], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(scanlines.tobytes(), ZLIB_LEVEL))
            + _chunk(b"IEND", b""))


def decode_image(data: bytes, channels: int = 3) -> np.ndarray:
    """Encoded image bytes -> uint8 [H, W, channels] (``tf.io.decode_image``
    with ``expand_animations=False``): PNG or JPEG, ``channels`` None or 0
    for the file's own."""
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data, channels)
    if data.startswith(JPEG_SIGNATURE):
        return decode_jpeg(data, channels)
    raise ValueError(f"unknown image format (first bytes {data[:8]!r})")
