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
from open_pi_zero_torch.ops.lora import is_quantized_base
from open_pi_zero_torch.ops.quantization import int8_mm_layout


def _to_tensor(x) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # numpy extension dtype: reinterpret the bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(tree, device="cuda", dtype=None) -> dict:
    """JAX param tree (numpy leaves) -> the port's tree of tensors on
    ``device`` (CUDA by default; raises without a card unless
    ``device='cpu'``). ``dtype`` casts every floating leaf but the scales
    of a quantized kernel (``scale``, ``absmax``), which stay fp32 as JAX
    keeps them. A W8A8 payload ``qa`` takes the port's column-major layout
    (``int8_mm_layout``)."""
    device = resolve_device(device)

    def convert(node, quantized: bool = False, key: str = ""):
        if isinstance(node, dict):
            inner = is_quantized_base(node)
            return {k: convert(v, inner, k) for k, v in node.items()}
        t = _to_tensor(node)
        if dtype is not None and t.is_floating_point() and not quantized:
            t = t.to(dtype)
        if quantized and key == "qa":
            t = int8_mm_layout(t)
        return t.to(device)

    return convert(tree)
