"""At-rest parameter memory of every serving tier (counterpart of the JAX
package's ``scripts/model_memory.py``), counted from ``meta`` tensors
(``pizero.abstract_params`` through ``fuse.prepare_for_serving``): no
weights, no card.

  python -m open_pi_zero_torch.scripts.model_memory [--tiny]

The reference's figures for comparison: 13.6 GB fp32 / 6.7 GB bf16 peak
inference memory on a 4090 (reference README.md:76-79); the 4-bit tier
exists to fit consumer cards (reference lora.py:214-360).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from open_pi_zero_torch.config import PiZeroConfig, tiny_pizero_config
from open_pi_zero_torch.models import fuse, pizero
from open_pi_zero_torch.models.tree import tree_leaves

TIERS = {
    "bf16 fused": dict(),
    "int8 expert (latency default)": dict(quantize_mixtures=("action",)),
    "int8 expert + W8A8 prefill (production)": dict(
        quantize_mixtures=("action",), w8a8_mixtures=("vlm",), w8a8_siglip=True
    ),
    "int8 whole trunk + W8A8": dict(quantize_mixtures=("vlm", "action"), w8a8_mixtures=(), w8a8_siglip=True),
    "NF4 whole trunk (memory tier)": dict(quantize_mixtures=("vlm", "action"), bits=4),
}


def tier_bytes(cfg: PiZeroConfig) -> Dict[str, int]:
    """{tier: bytes of its serving tree} for a bf16 model of ``cfg``."""
    out = {}
    for name, kwargs in TIERS.items():
        tree = fuse.prepare_for_serving(pizero.abstract_params(cfg, dtype=torch.bfloat16), **kwargs)
        out[name] = sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, int]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tiny", action="store_true")
    args = parser.parse_args(argv)
    sizes = tier_bytes(tiny_pizero_config() if args.tiny else PiZeroConfig())
    for name, b in sizes.items():
        if b >= 0.1 * 2**30:
            print(f"{name:42s} {b / 2**30:8.2f} GiB")
        else:
            print(f"{name:42s} {b / 2**20:8.2f} MiB")
    return sizes


if __name__ == "__main__":
    main()
