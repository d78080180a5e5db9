"""Host-side image resize: OpenCV's ``INTER_LANCZOS4`` on uint8 frames, in
numpy (the JAX package's env adapters call ``cv2.resize``; the card's
machine has no OpenCV).

The arithmetic is OpenCV's fixed-point path for 8-bit images, so the
result is bitwise ``cv2.resize(image, (w, h), interpolation=
cv2.INTER_LANCZOS4)``:
  - the source coordinate of destination index d is ``(d + 0.5) * scale
    - 0.5`` (``scale = 1 / (dst / src)`` in double, rounded to float32);
    its floor and fraction pick the 8 taps ``floor - 3 .. floor + 4``;
  - the tap weights are ``interpolateLanczos4``'s float32 windowed sincs,
    normalised to sum 1, rounded to int16 at scale 2048;
  - taps outside the image take the edge pixel (replicate);
  - an integer horizontal pass, then an integer vertical pass, then
    ``(v + 2**21) >> 22`` saturated to uint8.

Each axis' taps and weights for a (source, destination) length are folded
into one dense integer matrix (a tap repeated at the edge adds its
weights), cached per pair, and the two passes are two float64 matrix
products: every product and partial sum is an integer below 2**53, so
they are exact whatever order the BLAS sums in.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS
_S45 = 0.70710678118654752440084436210485
_CS = ((1.0, 0.0), (-_S45, -_S45), (0.0, 1.0), (_S45, -_S45),
       (-1.0, 0.0), (_S45, _S45), (0.0, -1.0), (-_S45, _S45))


def lanczos4_weights(x: np.float32) -> np.ndarray:
    """OpenCV's ``interpolateLanczos4(x)`` as int16 at scale 2048: the
    weights of taps -3..4 around a fractional offset ``x`` in [0, 1),
    computed in float32 and double as OpenCV computes them."""
    x3 = np.float32(x) + np.float32(3)
    y0 = -(float(x3) * math.pi) * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    coeffs = np.zeros(8, np.float32)
    total = np.float32(0)
    for i, (a, b) in enumerate(_CS):
        yi = np.float32(x3 - np.float32(i))
        if abs(yi) >= np.float32(1e-6):
            y = -(float(yi) * math.pi) * 0.25
            coeffs[i] = np.float32((a * s0 + b * c0) / (y * y))
        else:
            coeffs[i] = np.float32(1e30)
        total = np.float32(total + coeffs[i])
    coeffs = coeffs * (np.float32(1) / total)
    return np.clip(np.rint(coeffs * np.float32(1 << COEF_BITS)), -32768, 32767).astype(np.int16)


@functools.lru_cache(maxsize=16)
def resize_matrix(src: int, dst: int) -> np.ndarray:
    """The [dst, src] float64 matrix of one axis' integer tap weights
    (read-only: one cached copy per length pair)."""
    scale = 1.0 / (dst / src)
    m = np.zeros((dst, src), np.float64)
    for d in range(dst):
        fx = np.float32((d + 0.5) * scale - 0.5)
        sx = math.floor(fx)
        taps = np.clip(np.arange(sx - 3, sx + 5), 0, src - 1)
        np.add.at(m[d], taps, lanczos4_weights(np.float32(fx - np.float32(sx))))
    m.setflags(write=False)
    return m


def resize_lanczos4(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> uint8 [h, w(, C)] at ``size = (w, h)``
    (cv2's dsize order), bitwise ``cv2.resize(..., INTER_LANCZOS4)``."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"expected a uint8 image, got {image.dtype}")
    w, h = (int(s) for s in size)
    sh, sw = image.shape[:2]
    x = image.reshape(sh, sw, -1).astype(np.float64)
    c = x.shape[2]
    # horizontal pass: [w, sw] @ [sw, sh * c]
    rows = resize_matrix(sw, w) @ x.transpose(1, 0, 2).reshape(sw, sh * c)
    # vertical pass: [h, sh] @ [sh, w * c]
    out = resize_matrix(sh, h) @ rows.reshape(w, sh, c).transpose(1, 0, 2).reshape(sh, w * c)
    # (v + 2**21) >> 22 in float64: the add, the power-of-two scale and the
    # floor are exact on these integers
    out += 1 << (2 * COEF_BITS - 1)
    out *= 1.0 / (1 << (2 * COEF_BITS))
    np.floor(out, out=out)
    np.clip(out, 0, 255, out=out)
    return out.astype(np.uint8).reshape((h, w) + image.shape[2:])
