"""Data-pipeline smoke (counterpart of the JAX package's
``scripts/check_data.py``; reference scripts/data/check_bridge.py:15-40):
iterates the interleaved mix through the port's TF-free pipeline
(``data/pipeline.make_interleaved_dataset``), prints the batch shapes and
the action and proprio ranges, writes the first batch's frames as PNG
through the port's writer (``data/images.encode_png``), and prints the
frames per second.

  python -m open_pi_zero_torch.scripts.check_data --mix bridge \\
      [--data_path $VLA_DATA_DIR/resize_224] [--n_batches 5] [--batch_size 32] \\
      [--skip_norm] [--dump_dir /tmp/frames]

The statistics cache is ``$XDG_CACHE_HOME/open_pi_zero_torch``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np

from open_pi_zero_torch.data.images import encode_png
from open_pi_zero_torch.data.oxe import make_oxe_dataset_kwargs_and_weights
from open_pi_zero_torch.data.pipeline import make_interleaved_dataset


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data_path", type=str,
                        default=os.path.join(os.environ.get("VLA_DATA_DIR", "."), "resize_224"))
    parser.add_argument("--mix", type=str, default="bridge")
    parser.add_argument("--camera_views", nargs="*", default=("primary",))
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--n_batches", type=int, default=5)
    parser.add_argument("--skip_norm", action="store_true", help="use raw actions and proprio")
    parser.add_argument("--dump_dir", type=str, default="", help="write the first batch's frames as PNGs here")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Returns {"first": the first batch, "frames", "seconds",
    "frames_per_s"}."""
    args = parse_args(argv)
    kwargs_list, weights = make_oxe_dataset_kwargs_and_weights(
        args.mix, args.data_path, load_proprio=True, load_camera_views=tuple(args.camera_views)
    )
    if args.skip_norm:
        for kw in kwargs_list:
            kw["action_proprio_normalization_type"] = None
    ds = make_interleaved_dataset(
        kwargs_list,
        weights,
        train=True,
        shuffle_buffer_size=1000,
        batch_size=args.batch_size,
        traj_transform_kwargs=dict(window_size=1, action_horizon=4),
        frame_transform_kwargs=dict(resize_size={"primary": (224, 224)}),
    )
    it = iter(ds)
    t0 = time.time()
    first = None
    for i in range(args.n_batches):
        batch = next(it)
        obs = batch["observation"]
        img = obs["image_primary"]
        act = batch["action"]
        if i == 0:
            first = batch
            print("keys:", sorted(batch.keys()), "/ obs:", sorted(obs.keys()))
            print(f"image {img.shape} {img.dtype} [{img.min()}, {img.max()}]")
            prop = obs.get("proprio")
            if prop is not None:
                print(f"proprio {prop.shape} [{prop.min():.3f}, {prop.max():.3f}]")
            print(f"action {act.shape} [{act.min():.3f}, {act.max():.3f}] mean {act.mean(axis=(0, 1, 2))}")
            if args.dump_dir:
                os.makedirs(args.dump_dir, exist_ok=True)
                for j in range(min(8, img.shape[0])):
                    with open(os.path.join(args.dump_dir, f"frame_{j}.png"), "wb") as f:
                        f.write(encode_png(np.asarray(img[j, 0])))
                print(f"dumped frames to {args.dump_dir}")
        else:
            assert img.shape == first["observation"]["image_primary"].shape
    dt = time.time() - t0
    frames = args.n_batches * args.batch_size
    print(f"{frames} frames in {dt:.1f}s = {frames / dt:.1f} frames/s")
    return {"first": first, "frames": frames, "seconds": dt, "frames_per_s": frames / dt}


if __name__ == "__main__":
    main()
