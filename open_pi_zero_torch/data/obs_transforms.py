"""Frame-level observation transforms: decode, resize, augment, dropout
(counterpart of the JAX package's ``data/obs_transforms.py``; reference
src/data/obs_transforms.py, dlimp/augmentations.py and the Lanczos3 uint8
resize of dlimp/utils.py:12-17), in numpy.

``resize_image`` is ``tf.image.resize(method="lanczos3", antialias=True)``
in float32: TensorFlow's scale-and-translate weights rebuilt per axis (its
float32 arithmetic for the sample positions, the spans and the kernel; the
kernel widened by 1/scale when downsampling; each output's weights
normalized to sum 1), folded into one dense float32 matrix per (source
length, destination length), cached. The rows are resized first, then the
columns, as TensorFlow does; the sums run in the matrix product's order,
not TensorFlow's, so the floats differ by rounding only.

The augment ops are TensorFlow's deterministic image ops at given
parameters (``adjust_brightness``, ``adjust_contrast``,
``adjust_saturation``, ``adjust_hue``: TensorFlow's per-pixel RGB <-> HSV
arithmetic) and the JAX package's random resized crop. Their parameters
are drawn from an explicit generator, one per frame derived from (dataset
seed, frame index) as the JAX package derives ``seed + i``; every image in
a frame's history takes the same parameters. TensorFlow's stateless Philox
draws are not reproduced: the laws are the same, the draws are not.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from open_pi_zero_torch.data import images

_F = np.float32
_PI = _F(3.14159265359)  # the kernel's float constant
LANCZOS_RADIUS = _F(3.0)


def decode_image(x: bytes, channels: int = 3) -> np.ndarray:
    """Encoded bytes -> uint8 [H, W, channels]."""
    return images.decode_image(x, channels)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    """TensorFlow's LanczosKernelFunc(3) in float32."""
    x = np.abs(x).astype(_F)
    r = LANCZOS_RADIUS
    with np.errstate(divide="ignore", invalid="ignore"):
        val = r * np.sin(_PI * x) * np.sin(_PI * x / r) / (_PI * _PI * x * x)
    return np.where(x > r, _F(0), np.where(x <= _F(1e-3), _F(1), val)).astype(_F)


@functools.lru_cache(maxsize=None)
def resize_matrix(in_len: int, out_len: int) -> np.ndarray:
    """[out_len, in_len] float32 weights of one axis of
    ``tf.image.resize(..., "lanczos3", antialias=True)`` (TensorFlow's
    ``ComputeSpansCore`` with translate 0)."""
    scale = _F(out_len) / _F(in_len)
    inv_scale = _F(1.0 / float(scale))
    kernel_scale = max(inv_scale, _F(1.0))
    reach = LANCZOS_RADIUS * kernel_scale
    span = min(2 * int(np.ceil(reach)) + 1, in_len)
    one_over = _F(1.0) / kernel_scale
    out = np.zeros((out_len, in_len), _F)
    for x in range(out_len):
        sample = _F(x + _F(0.5)) * inv_scale
        if sample < 0 or sample > in_len:
            continue
        start = int(np.ceil(sample - reach - _F(0.5)))
        end = int(np.floor(sample + reach - _F(0.5)))
        start = min(max(start, 0), in_len - 1)
        end = min(max(end, 0), in_len - 1) + 1
        if end - start > span:
            raise AssertionError("span wider than TensorFlow's")
        src = np.arange(start, end)
        weights = _lanczos3((src.astype(_F) + _F(0.5) - sample) * one_over)
        total = _F(0)
        for w in weights:  # TensorFlow's sequential float32 sum
            total = _F(total + w)
        if abs(total) >= 1000.0 * np.finfo(_F).tiny:
            out[x, start:end] = weights * (_F(1.0) / total)
    return out


def resize_float(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[H, W, C] -> float32 [*size, C]: rows, then columns."""
    h, w, c = image.shape
    rows = resize_matrix(h, size[0]) @ image.astype(_F).reshape(h, w * c)
    return np.matmul(resize_matrix(w, size[1]), rows.reshape(size[0], w, c))


def resize_image(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Lanczos3 resize on float, rounded back to uint8 (matches dlimp)."""
    return np.clip(np.round(resize_float(image, size)), 0, 255).astype(np.uint8)


def maybe_decode_and_resize(x, size: Optional[Tuple[int, int]], channels: int = 3) -> np.ndarray:
    """bytes -> decoded+resized uint8; b'' -> zeros [*size, C]
    (reference obs_transforms.py decode_and_resize)."""
    if isinstance(x, (bytes, bytearray)):
        if size is None:
            raise ValueError("padding image requires a target size")
        if not x:
            return np.zeros((*size, channels), np.uint8)
        img = decode_image(bytes(x), channels)
        return resize_image(img, size) if size is not None else img
    return resize_image(x, size) if size is not None else x


# --------------------------------------------------------------------------- #
# TensorFlow's deterministic image ops, on float32 [H, W, 3] in [0, 1]
# --------------------------------------------------------------------------- #


def adjust_brightness(image: np.ndarray, delta: float) -> np.ndarray:
    return (image + _F(delta)).astype(_F)


def adjust_contrast(image: np.ndarray, factor: float) -> np.ndarray:
    """(x - mean) * factor + mean, the mean per channel over the image."""
    mean = image.mean(axis=(0, 1), dtype=_F)
    return ((image - mean) * _F(factor) + mean).astype(_F)


def _rgb_to_hsv(r, g, b):
    """TensorFlow's adjust_saturation ``rgb_to_hsv``: h in [0, 1)."""
    v = np.maximum(r, np.maximum(g, b))
    rng_ = v - np.minimum(r, np.minimum(g, b))
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(v > 0, rng_ / v, _F(0)).astype(_F)
        norm = _F(1.0) / (_F(6.0) * rng_)
        h = np.where(
            r == v, norm * (g - b),
            np.where(g == v, (norm * (b - r)).astype(np.float64) + 2.0 / 6.0,
                     (norm * (r - g)).astype(np.float64) + 4.0 / 6.0).astype(_F),
        ).astype(_F)
    h = np.where(rng_ <= 0, _F(0), h)
    h = np.where(h < 0, h + _F(1), h).astype(_F)
    return h, s, v


def _hsv_to_rgb(h, s, v):
    c = (s * v).astype(_F)
    m = (v - c).astype(_F)
    dh = (h * _F(6)).astype(_F)
    category = dh.astype(np.int32)  # a cast truncates toward zero, as static_cast<int>
    fmodu = np.where(dh <= 0, dh + _F(2), dh).astype(_F)
    fmodu = (fmodu - _F(2) * np.floor(fmodu / _F(2))).astype(_F)  # subtracting 2 is exact here
    x = (c * (_F(1) - np.abs(fmodu - _F(1)))).astype(_F)
    zero = np.zeros_like(c)
    table = {0: (c, x, zero), 1: (x, c, zero), 2: (zero, c, x), 3: (zero, x, c), 4: (x, zero, c), 5: (c, zero, x)}
    out = []
    for ch in range(3):
        conds = [category == k for k in range(6)]
        out.append((np.select(conds, [table[k][ch] for k in range(6)], zero) + m).astype(_F))
    return out


def adjust_saturation(image: np.ndarray, factor: float) -> np.ndarray:
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    h, s, v = _rgb_to_hsv(r, g, b)
    s = np.minimum(_F(1), np.maximum(_F(0), (s * _F(factor)).astype(_F)))
    return np.stack(_hsv_to_rgb(h, s, v), axis=-1)


def adjust_hue(image: np.ndarray, delta: float) -> np.ndarray:
    """TensorFlow's adjust_hue: hue on [0, 6) from the channels' order and
    the middle one's ratio, shifted by 6 delta, the value range kept."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    r_lt_g = r < g
    cases = [
        r_lt_g & (b < r), r_lt_g & (b > g), r_lt_g,
        ~r_lt_g & (b < g), ~r_lt_g & (b > r), ~r_lt_g,
    ]  # np.select takes the first that holds: the C++ if/else chain
    v_max = np.select(cases, [g, b, g, r, b, r])
    v_mid = np.select(cases, [r, g, b, g, r, b])
    v_min = np.select(cases, [b, r, r, b, g, g])
    category = np.select(cases, [1, 3, 2, 0, 4, 5])
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = ((v_mid - v_min) / (v_max - v_min)).astype(_F)
    increase = category % 2 == 0
    h = (category.astype(_F) + np.where(increase, ratio, _F(1) - ratio)).astype(_F)
    h = np.where(v_max == v_min, _F(0), h)
    h = (h + _F(delta) * _F(6)).astype(_F)
    h = np.where(h < 0, h + _F(6), h).astype(_F)
    h = np.where(h >= 6, h - _F(6), h).astype(_F)
    category = h.astype(np.int32)
    ratio = (h - category.astype(_F)).astype(_F)
    ratio = np.where(category % 2 == 0, ratio, _F(1) - ratio)
    v_mid = (v_min + ratio * (v_max - v_min)).astype(_F)
    conds = [category == k for k in range(5)]
    out_r = np.select(conds, [v_max, v_mid, v_min, v_min, v_mid], v_max)
    out_g = np.select(conds, [v_mid, v_max, v_max, v_mid, v_min], v_min)
    out_b = np.select(conds, [v_min, v_min, v_mid, v_max, v_max], v_mid)
    return np.stack([out_r, out_g, out_b], axis=-1).astype(_F)


def crop_and_resize(image: np.ndarray, y0: int, x0: int, h: int, w: int) -> np.ndarray:
    """The crop [y0:y0+h, x0:x0+w], resized back to the image's size in
    float (``tf.image.crop_to_bounding_box`` then ``tf.image.resize``)."""
    height, width = image.shape[:2]
    return resize_float(image[y0:y0 + h, x0:x0 + w], (height, width))


# --------------------------------------------------------------------------- #
# random parameters and the augment chain (dlimp semantics)
# --------------------------------------------------------------------------- #


def _draw(name: str, args, image_shape, rng: np.random.Generator):
    """One op's parameters, drawn as the JAX package's stateless ops draw
    them (the same laws)."""
    if name == "random_resized_crop":
        height, width = image_shape[:2]
        scale, ratio = args["scale"], args["ratio"]
        s = _F(rng.uniform(scale[0], scale[1]))
        log_r = _F(rng.uniform(np.log(_F(ratio[0])), np.log(_F(ratio[1]))))
        r = np.exp(log_r).astype(_F)
        area = _F(height * width) * s
        w = min(int(np.round(np.sqrt(_F(area * r)))), width)
        h = min(int(np.round(np.sqrt(_F(area / r)))), height)
        x0 = int(rng.integers(0, width - w + 1))
        y0 = int(rng.integers(0, height - h + 1))
        return (y0, x0, h, w)
    if not isinstance(args, (list, tuple, dict)):
        args = [args]
    if isinstance(args, dict):
        args = list(args.values())
    if name in ("random_brightness", "random_hue"):
        return _F(rng.uniform(-args[0], args[0]))
    if name in ("random_contrast", "random_saturation"):
        return _F(rng.uniform(args[0], args[1]))
    if name == "random_flip_left_right":
        return bool(rng.random() < 0.5)
    raise ValueError(f"unknown augment op {name!r}")


_APPLY = {
    "random_resized_crop": lambda img, p: crop_and_resize(img, *p),
    "random_brightness": adjust_brightness,
    "random_contrast": adjust_contrast,
    "random_saturation": adjust_saturation,
    "random_hue": adjust_hue,
    "random_flip_left_right": lambda img, flip: img[:, ::-1] if flip else img,
}


def draw_augment_params(image_shape, rng: np.random.Generator, **kwargs) -> list:
    """[(op name, parameters)] of kwargs["augment_order"], in order."""
    order: Sequence[str] = kwargs.get("augment_order", [])
    return [(name, _draw(name, kwargs.get(name, []), image_shape, rng)) for name in order]


def augment_image(image: np.ndarray, params: list) -> np.ndarray:
    """Apply drawn ops to a uint8 image in the float [0, 1] domain, clipped
    after each op, rounded back to uint8 (dlimp semantics)."""
    x = image.astype(_F) / _F(255.0)
    for name, p in params:
        x = np.clip(_APPLY[name](x, p), _F(0), _F(1)).astype(_F)
    return np.round(x * _F(255.0)).astype(np.uint8)


def image_dropout(obs: dict, rng: np.random.Generator, dropout_prob: float) -> dict:
    """Independently drop each REAL camera image with prob `dropout_prob`,
    but always keep one randomly chosen real image; padding images are left
    alone; the pad mask is updated for dropped cameras (reference
    obs_transforms.py image_dropout semantics)."""
    image_keys = [k for k in obs if k.startswith("image_")]
    if not image_keys:
        return obs
    pad = obs.get("pad_mask_dict", {})
    valid = np.asarray([bool(np.reshape(pad[k], -1)[0]) if k in pad else True for k in image_keys])
    keep_idx = int(rng.choice(np.flatnonzero(valid))) if valid.any() else 0
    rands = rng.random(len(image_keys))
    keep = valid & ((np.arange(len(image_keys)) == keep_idx) | (rands > dropout_prob))
    obs = dict(obs)
    if "pad_mask_dict" in obs:
        obs["pad_mask_dict"] = dict(obs["pad_mask_dict"])
    for i, k in enumerate(image_keys):
        if not keep[i]:
            obs[k] = np.zeros_like(obs[k])
        if "pad_mask_dict" in obs and k in obs["pad_mask_dict"]:
            obs["pad_mask_dict"][k] = obs["pad_mask_dict"][k] & keep[i]
    return obs


def apply_obs_transforms(
    frame: dict,
    rng: np.random.Generator,
    resize_size: Dict[str, Tuple[int, int]],
    image_augment_kwargs: Optional[Dict[str, dict]] = None,
    image_dropout_prob: float = 0.0,
    train: bool = True,
) -> dict:
    """Decode/resize all image_<name> keys of a chunked observation dict
    ([W] history of encoded strings), then optionally augment and drop
    (reference obs_transforms.py:15-172 + dataset.py:178-254). ``rng`` is
    the frame's own generator."""
    obs = dict(frame["observation"])
    for key in list(obs):
        if not key.startswith("image_"):
            continue
        name = key[len("image_"):]
        size = resize_size.get(name)
        decoded = np.stack([maybe_decode_and_resize(x, size) for x in obs[key]])  # [W, H, W, C]
        if train and image_augment_kwargs and name in image_augment_kwargs:
            params = draw_augment_params(decoded.shape[1:], rng, **image_augment_kwargs[name])
            decoded = np.stack([augment_image(x, params) for x in decoded])
        obs[key] = decoded
    if train and image_dropout_prob > 0:
        obs = image_dropout(obs, rng, image_dropout_prob)
    frame = dict(frame)
    frame["observation"] = obs
    return frame
