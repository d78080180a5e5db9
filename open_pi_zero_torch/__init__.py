"""open_pi_zero_torch: the PyTorch/CUDA port of the π0 vision-language-action
stack, beside the JAX package it is held against.

It mirrors the JAX package's module names (``ops/``, ``models/``,
``serving.py``). Params are nested dicts of tensors in the JAX tree's
layout (``[in, out]`` kernels, stacked ``[L, ...]`` layers), and public
functions keep the ``[B, L, H, D]`` activation layout. Every kernel the
JAX package wrote in Pallas for the TPU is a kernel written by hand for
Hopper under ``csrc/``; on a CPU tensor each op takes its plain PyTorch
version instead.

The package imports torch and numpy only: never jax, yaml or the JAX
package.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point builds on. Entry points default to CUDA and
    raise when there is no card, unless the caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device
