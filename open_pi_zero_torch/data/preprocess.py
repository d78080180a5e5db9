"""Offline RLDS preprocessing: a one-time resize and JPEG re-encode of every
image observation of a dataset (counterpart of the JAX package's
``data/preprocess.py``; reference ResizeAndJpegEncode mod,
src/data/oxe/preprocess/mod_functions.py:57-100; driven by
``scripts/modify_rlds_dataset.py``).

Episodes stream through the port's RLDS reader and writer
(``data/rlds.py``): each is read, its frames decoded (``decode_image``:
JPEG through the port's codec, or PNG), resized with the pipeline's
Lanczos3 (``obs_transforms.resize_image``) and re-encoded as JPEG at
quality 95 in a thread pool, and written before the next is read. The
codec releases the GIL, so threads share the work without pickling
episodes across processes. The output has the JAX package's leaf specs and
shard count; empty byte strings (padding frames) pass through.

JPEG frames decode with libjpeg's ISLOW IDCT (``INTEGER_ACCURATE``), not
the training pipeline's IFAST: the JAX package decodes them through
``native_io.decode_jpeg``, a host libjpeg at its default (ISLOW), and
falls back to TensorFlow only where that library fails, as it does on a
PNG frame. The two IDCTs give frames several levels apart, which the
resize and the re-encode carry into the output. PNG frames decode as
TensorFlow's do (lossless, no IDCT).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np

from open_pi_zero_torch.data import rlds
from open_pi_zero_torch.data.images import decode_image
from open_pi_zero_torch.data.jpeg import encode_jpeg
from open_pi_zero_torch.data.obs_transforms import resize_image

log = logging.getLogger(__name__)

JPEG_QUALITY = 95
JPEG_DCT_METHOD = "INTEGER_ACCURATE"  # the JAX package's libjpeg decode (module docstring)


def resize_frame(encoded: bytes, size: Tuple[int, int]) -> np.ndarray:
    """An encoded frame -> RGB uint8 [*size, 3], resized (a JPEG decoded
    with ``JPEG_DCT_METHOD``)."""
    return resize_image(decode_image(encoded, 3, JPEG_DCT_METHOD), size)


def resize_encode(encoded: bytes, size: Tuple[int, int]) -> bytes:
    """An encoded frame -> the JPEG of it resized; b'' stays b''."""
    if not encoded:
        return encoded
    return encode_jpeg(resize_frame(encoded, size), quality=JPEG_QUALITY)


def resized_leaves(spec: rlds.DatasetSpec, size: Tuple[int, int]) -> List[rlds.LeafSpec]:
    """The dataset's leaves, each image leaf now [*size, 3] JPEG."""
    return [
        rlds.LeafSpec(
            l.key, l.dtype, (size[0], size[1], 3) if l.kind == "image" else l.shape,
            l.kind, l.in_steps, "jpeg" if l.kind == "image" else l.encoding_format,
        )
        for l in spec.leaves
    ]


def resize_rlds_dataset(
    src_dir: str,
    dst_dir: str,
    size: Tuple[int, int] = (224, 224),
    splits: Optional[List[str]] = None,
    num_workers: int = 8,
    episodes_per_shard: int = 64,
) -> None:
    """Copy an RLDS dataset with every image leaf resized to ``size`` and
    re-encoded as JPEG. Non-image leaves pass through unchanged."""
    spec = rlds.load_spec(src_dir)
    image_keys = [l.key for l in spec.leaves if l.kind == "image"]
    leaves = resized_leaves(spec, size)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:

        def resized(episodes) -> Iterator[dict]:
            for ep in episodes:
                flat = rlds._flatten(ep)
                for key in image_keys:
                    frames = list(pool.map(lambda e: resize_encode(e, size), flat[key]))
                    flat[key] = np.empty(len(frames), object)
                    flat[key][:] = frames
                yield rlds._unflatten(flat)

        for split in splits or list(spec.splits):
            name, start, end = rlds.parse_split(split, spec.num_episodes(split.split("[")[0]))
            count = end - start
            shards = max(1, count // episodes_per_shard)
            episodes = rlds.episode_dataset(src_dir, split=split, spec=spec)
            rlds.write_rlds_dataset(dst_dir, spec.name, resized(episodes), leaves, split=split, shards=shards,
                                    num_episodes=count)
            log.info("split %s: %d episodes -> %s (%d shards)", split, count, dst_dir, shards)
