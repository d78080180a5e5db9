"""Offline RLDS resize and JPEG re-encode (counterpart of the JAX package's
``scripts/modify_rlds_dataset.py``; reference
scripts/data/modify_rlds_dataset.py): shrink OXE datasets to 224x224 once,
so that training never decodes full-size frames. No TensorFlow.

Usage:
  python -m open_pi_zero_torch.scripts.modify_rlds_dataset \\
      --src /data/bridge_dataset --dst /data/resize_224/bridge_dataset \\
      --size 224 224 --workers 16
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

from open_pi_zero_torch.data.preprocess import resize_rlds_dataset


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", required=True, help="source RLDS dataset dir")
    parser.add_argument("--dst", required=True, help="destination dir")
    parser.add_argument("--size", type=int, nargs=2, default=(224, 224))
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--splits", nargs="*", default=None)
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    resize_rlds_dataset(args.src, args.dst, tuple(args.size), splits=args.splits, num_workers=args.workers)


if __name__ == "__main__":
    main()
