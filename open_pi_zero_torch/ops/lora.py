"""LoRA adapters and quantized base weights as tree transforms
(counterpart of the JAX package's ``ops/lora.py``; reference
src/model/lora.py:83-360).

An adapter is a sibling subtree ``<name>_lora: {a [(L,) in, r], b [(L,)
r, out]}`` next to the base kernel it adapts, stacked ``[L, ...]`` like its
kernel: A ~ U(+-1/sqrt(in)) and B = 0, so training starts at the base
function (``lora_init``). ``merge_lora`` folds every adapter into its base
(dequantizing a quantized base first) for serving; ``lora_label_fn``
labels the adapters apart from the rest (the optimizer's LoRA labels).
The quantized base kernels are made, found and undone by
``quantize_base_weights``, ``is_quantized_base`` and
``dequantize_base_weights``.

The projections themselves (``proj``, ``base_matmul``, ``lora_delta``)
live in ``ops/linear.py``.
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


def lora_init(
    generator: torch.Generator, in_dim: int, out_dim: int, r: int, dtype=torch.float32, stack: int = 0
) -> dict:
    """A ~ U(+-1/sqrt(in_dim)) (torch's kaiming_uniform(a=sqrt(5)) on an
    [r, in] matrix) drawn from ``generator`` on its device, B = 0; with
    ``stack`` both carry a leading [stack] axis."""
    bound = 1.0 / in_dim**0.5
    lead = (stack,) if stack else ()
    a = torch.empty((*lead, in_dim, r), dtype=dtype, device=generator.device)
    return {
        "a": a.uniform_(-bound, bound, generator=generator),
        "b": torch.zeros((*lead, r, out_dim), dtype=dtype, device=generator.device),
    }


def _merged(base, lora: dict, scaling: float) -> torch.Tensor:
    """The base kernel (a quantized one decoded) in fp32 plus
    ``scaling * A @ B`` in fp32, cast to the adapter's dtype."""
    delta = scaling * torch.matmul(lora["a"].to(torch.float32), lora["b"].to(torch.float32))
    return (dequantize_base_weights(base).to(torch.float32) + delta).to(lora["a"].dtype)


def merge_lora(params, scaling: float = 1.0):
    """Fold every ``<name>_lora`` adapter into its base kernel and drop the
    adapter (the reference's eval-time merge, LoRALinear.train(False)). A
    biased SigLIP linear {kernel, bias} keeps its bias. Returns a new tree."""

    def merge_dict(d: dict) -> dict:
        out = {}
        for k, v in d.items():
            if k.endswith("_lora"):
                continue
            if isinstance(v, dict) and "a" not in v:
                v = merge_dict(v)
            lora = d.get(f"{k}_lora")
            if lora is not None and isinstance(v, dict) and "kernel" in v:
                v = {**v, "kernel": _merged(v["kernel"], lora, scaling)}
            elif lora is not None:
                v = _merged(v, lora, scaling)
            out[k] = v
        return out

    return merge_dict(params)


def lora_label_fn(params, lora_label: str = "lora", base_label: str = "frozen"):
    """Label tree: adapters ``lora_label``, everything else ``base_label``
    (reference mark_only_lora_as_trainable, lora.py:366+)."""

    def walk(d, in_lora):
        if isinstance(d, dict):
            return {k: walk(v, in_lora or k.endswith("_lora")) for k, v in d.items()}
        return lora_label if in_lora else base_label

    return walk(params, False)


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
