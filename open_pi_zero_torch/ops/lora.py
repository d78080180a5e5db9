"""Tree transforms of the quantized base weights (counterpart of the tree
part of the JAX package's ``ops/lora.py``): quantize the kernels of a
param tree, find and undo the quantization.

The projections themselves (``proj``, ``base_matmul``, ``lora_delta``)
live in ``ops/linear.py``. ``has_lora`` finds adapters; making them,
``merge_lora`` and the LoRA labels are not ported yet.
"""

from __future__ import annotations

import torch

from open_pi_zero_torch.ops.quantization import (
    dequantize_kernel_nf4,
    int8_mm_layout,
    quantize_int8_rowwise,
    quantize_kernel_nf4,
)

# includes the fused serving keys (models/fuse.py), so that quantization
# can follow fusion: per-output-channel scales of a concatenated kernel are
# those of the separate kernels
QUANTIZE_KEYS = ("q", "k", "v", "o", "gate", "up", "down", "qkv", "gateup")


def _is_int8_payload(d: dict) -> bool:
    """{q|qa, scale}: ``q`` not a dict tells an int8 payload from an
    attention dict whose q kernel is itself quantized."""
    return "scale" in d and ("qa" in d or ("q" in d and not isinstance(d["q"], dict)))


def is_quantized_base(d) -> bool:
    """True if ``d`` is one quantized kernel: {q4, absmax} or {q|qa, scale}."""
    return isinstance(d, dict) and (("q4" in d and "absmax" in d) or _is_int8_payload(d))


def has_lora(params) -> bool:
    """True if any `<name>_lora` adapter subtree is present."""
    if isinstance(params, dict):
        return any(k.endswith("_lora") or has_lora(v) for k, v in params.items())
    return False


def has_quantized_bases(tree) -> bool:
    """True if any quantized kernel is left in the tree."""
    if isinstance(tree, dict):
        if {"q4", "qa"} & set(tree) or _is_int8_payload(tree):
            return True
        return any(has_quantized_bases(v) for v in tree.values())
    return False


def quantize_base_weights(
    tree,
    keys=QUANTIZE_KEYS,
    bits: int = 8,
    w8a8: bool = False,
    mse_scale: bool = False,
):
    """Replace every float kernel of 2 or more dims under one of ``keys``
    with its quantized dict: bits=8 -> {q, scale} per output channel (under
    ``qa`` with ``w8a8``, whose activations are then quantized per token as
    well), bits=4 -> NF4 {q4, absmax}. A stacked [L, in, out] kernel
    quantizes layer by layer. A W8A8 payload is stored column-major in its
    last two dims (``int8_mm_layout``), once, here. Quantized dicts are left
    as they are, so the walk is idempotent. Returns a new tree; the input
    is not changed."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if w8a8 and bits == 4:
        raise ValueError("w8a8 is an int8 tier")
    payload = "qa" if w8a8 else "q"

    def quantize(w: torch.Tensor) -> dict:
        if bits == 4:
            return quantize_kernel_nf4(w)
        if w.ndim == 2:
            q, scale = quantize_int8_rowwise(w, mse_scale=mse_scale)
        else:
            parts = [quantize_int8_rowwise(x, mse_scale=mse_scale) for x in w.unbind(0)]
            q, scale = torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])
        return {payload: int8_mm_layout(q) if w8a8 else q, "scale": scale}

    def walk(d):
        if not isinstance(d, dict) or is_quantized_base(d):
            return d
        return {
            k: quantize(v) if k in keys and torch.is_tensor(v) and v.ndim >= 2 else walk(v)
            for k, v in d.items()
        }

    return walk(tree)


def dequantize_base_weights(tree, dtype=torch.float32):
    """Every quantized kernel back to a float kernel in ``dtype`` (payload
    times scale in fp32, then one cast): the inverse walk of
    ``quantize_base_weights``, for transforms that need float kernels."""
    if isinstance(tree, dict):
        if "q4" in tree and "absmax" in tree:
            return dequantize_kernel_nf4(tree, dtype)
        if _is_int8_payload(tree):
            payload = tree["q"] if "q" in tree else tree["qa"]
            scale = tree["scale"]
            if payload.ndim == 3:  # stacked [L, in, out], scale [L, out]
                scale = scale[:, None, :]
            return (payload.to(torch.float32) * scale).to(dtype)
        return {k: dequantize_base_weights(v, dtype) for k, v in tree.items()}
    return tree


def quantize_per_model_config(params: dict, model_cfg) -> dict:
    """The config's QLoRA base quantization: NF4 for the mixtures with
    ``use_quantize`` and, with ``siglip.use_quantize``, for SigLIP's layer
    kernels, as the JAX TrainAgent applies it after loading weights."""
    qmix = [
        n
        for n in model_cfg.joint.mixture_names
        if model_cfg.joint.mixture(n).use_quantize and n in params["joint"]["mixtures"]
    ]
    if qmix:
        mixtures = dict(params["joint"]["mixtures"])
        for n in qmix:
            mixtures[n] = quantize_base_weights(mixtures[n], bits=4)
        params = {**params, "joint": {**params["joint"], "mixtures": mixtures}}
    if model_cfg.siglip.use_quantize:
        sig = {**params["siglip"]}
        sig["layers"] = quantize_base_weights(sig["layers"], keys=("kernel",), bits=4)
        params = {**params, "siglip": sig}
    return params
