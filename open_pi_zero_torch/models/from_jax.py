"""Param trees from the JAX package into the port.

The port keeps the JAX tree's layout (``[in, out]`` kernels, stacked
``[L, ...]`` layers), so the conversion is a leaf-by-leaf copy. The caller
hands over the JAX tree with numpy leaves (anything ``np.asarray`` reads,
bfloat16 included); this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from open_pi_zero_torch import resolve_device
from open_pi_zero_torch.models.tree import tree_map


def _to_tensor(x) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # numpy extension dtype: reinterpret the bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(tree, device="cuda", dtype=None) -> dict:
    """JAX param tree (numpy leaves) -> the port's tree of tensors on
    ``device`` (CUDA by default; raises without a card unless
    ``device='cpu'``). ``dtype`` casts every floating leaf."""
    device = resolve_device(device)

    def leaf(x):
        t = _to_tensor(x)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(leaf, tree)
