"""The serving layout (counterpart of the JAX package's ``models/fuse.py``):
fused q/k/v and gate/up kernels, then the quantized tiers.

Fusion concatenates the q, k and v kernels (and SigLIP's biases) into one
``qkv`` and the gate and up kernels into one ``gateup``, so that each
attention block runs one input projection instead of three and each geglu
MLP one instead of two. ``models/mixture.py`` and ``models/siglip.py`` split
the fused output; concatenating columns changes no dot product.

Fusion refuses trees with live LoRA adapters or quantized kernels: fuse
first, then quantize (``prepare_for_serving``). A fused tree is not for
tensor parallelism: ``parallel/sharding.py`` refuses it, since a split of
the concatenated out dim would cut across the q|k|v segments. TP serving
keeps the canonical layout.
"""

from __future__ import annotations

import torch

from open_pi_zero_torch import resolve_device
from open_pi_zero_torch.models import pizero
from open_pi_zero_torch.ops import lora as lora_lib


def _assert_fusable(d: dict, names) -> None:
    for n in names:
        if f"{n}_lora" in d:
            raise ValueError("cannot fuse projections with live LoRA adapters: merge them first")
        if lora_lib.has_quantized_bases(d.get(n)):
            raise ValueError(
                "cannot fuse quantized bases: fusion is for the float serving path "
                "(fuse first, then quantize)"
            )


def fuse_mixture_layers(layers: dict) -> dict:
    """A mixture's stacked layers with attn {qkv, o} and mlp {gateup, down}."""
    attn, mlp = dict(layers["attn"]), dict(layers["mlp"])
    _assert_fusable(attn, ("q", "k", "v"))
    _assert_fusable(mlp, ("gate", "up"))
    qkv = torch.cat([attn.pop("q"), attn.pop("k"), attn.pop("v")], dim=-1)
    gateup = torch.cat([mlp.pop("gate"), mlp.pop("up")], dim=-1)
    return {**layers, "attn": {"qkv": qkv, **attn}, "mlp": {"gateup": gateup, **mlp}}


def fuse_siglip_layers(layers: dict) -> dict:
    """SigLIP's stacked layers with attn {qkv: {kernel, bias}, o}."""
    attn = dict(layers["attn"])
    _assert_fusable(attn, ("q", "k", "v"))
    q, k, v = attn.pop("q"), attn.pop("k"), attn.pop("v")
    qkv = {part: torch.cat([q[part], k[part], v[part]], dim=-1) for part in ("kernel", "bias")}
    return {**layers, "attn": {"qkv": qkv, **attn}}


def fuse_for_serving(params: dict) -> dict:
    """A PiZero param tree in the fused layout (a new tree; the input is not
    changed, and the leaves that fusion leaves alone are shared)."""
    out = dict(params)
    if "siglip" in out:
        out["siglip"] = {**out["siglip"], "layers": fuse_siglip_layers(out["siglip"]["layers"])}
    if "joint" in out:
        mixtures = {
            name: {**m, "layers": fuse_mixture_layers(m["layers"])}
            for name, m in out["joint"]["mixtures"].items()
        }
        out["joint"] = {**out["joint"], "mixtures": mixtures}
    return out


def _mixture_tier(quantize_mixtures, bits, w8a8_mixtures):
    """(name, fused mixture params) -> the mixture in its tier: weight-only
    (int8 or NF4) if named in ``quantize_mixtures``, else W8A8 if named in
    ``w8a8_mixtures``, else as it is."""

    def tier(name: str, params: dict) -> dict:
        if name in quantize_mixtures:
            return lora_lib.quantize_base_weights(params, bits=bits)
        if name in w8a8_mixtures:
            return lora_lib.quantize_base_weights(params, w8a8=True)
        return params

    return tier


def _quantize_siglip(params: dict) -> dict:
    """W8A8 on SigLIP's layer kernels; the patch and position embeddings and
    the projector stay float."""
    layers = lora_lib.quantize_base_weights(params["layers"], keys=("kernel",), w8a8=True)
    return {**params, "layers": layers}


def prepare_for_serving(
    params: dict,
    quantize_mixtures=(),
    bits: int = 8,
    w8a8_mixtures=(),
    w8a8_siglip: bool = False,
) -> dict:
    """The serving layout of a float tree: fuse, then quantize.
      quantize_mixtures, bits=8   weight-only int8 per output channel: the
          tier of the action expert, whose weights the Euler loop streams 10
          times per chunk
      quantize_mixtures, bits=4   NF4 in blocks of 64 (a memory tier;
          ``infer_action`` decodes it once per call to int8)
      w8a8_mixtures, w8a8_siglip  W8A8: int8 x int8 products with the
          activations quantized per token, for the towers that run once per
          chunk at prefill
    Each fused mixture is replaced by its quantized copy in place, so that
    its fused float copy is freed then, not at the end. Adapters must be
    merged first. JAX's ``code``, whose one legal value is NF4, and its
    ``w8a8_keys`` and ``mse_scale`` knobs, which none of its callers sets,
    are not taken here."""
    tier = _mixture_tier(quantize_mixtures, bits, w8a8_mixtures)
    params = fuse_for_serving(params)
    mixtures = params["joint"]["mixtures"]  # fuse_for_serving's own dict
    for name in list(mixtures):  # "proprio" is absent when tied to "action"
        mixtures[name] = tier(name, mixtures[name])
    if w8a8_siglip:
        params["siglip"] = _quantize_siglip(params["siglip"])
    return params


def serving_layout_kwargs(cfg) -> dict:
    """The eval config's serving-tier knobs (any mapping with ``.get``) as
    the kwargs of ``prepare_for_serving`` and ``build_serving_params``, with
    the production defaults:
      quantize=true          false: the fused bf16 layout, no kwargs
      quantize_mixtures      the weight-only tier's mixtures (action)
      quantize_bits          8 = int8, 4 = NF4
      quantize_code          "nf4", the one 4-bit code (JAX's too);
                             any other value raises
      w8a8=true              W8A8 on the VLM trunk
      w8a8_siglip=false      W8A8 on SigLIP too (the JAX package's
                             min-latency tier, at a larger drift)"""
    if not bool(cfg.get("quantize", True)):
        return {}
    code = str(cfg.get("quantize_code", "nf4"))
    if code != "nf4":
        raise ValueError(f"unknown 4-bit code {code!r}: the serving layout has NF4 only")
    w8a8 = bool(cfg.get("w8a8", True))
    return dict(
        quantize_mixtures=tuple(cfg.get("quantize_mixtures", ("action",))),
        bits=int(cfg.get("quantize_bits", 8)),
        w8a8_mixtures=("vlm",) if w8a8 else (),
        w8a8_siglip=w8a8 and bool(cfg.get("w8a8_siglip", False)),
    )


def build_serving_params(
    cfg,
    *,
    seed: int = 0,
    device="cuda",
    dtype=torch.bfloat16,
    quantize_mixtures=(),
    bits: int = 8,
    w8a8_mixtures=(),
    w8a8_siglip: bool = False,
) -> dict:
    """``prepare_for_serving(pizero.init_params(cfg, seed=seed, ...), ...)``
    without the whole float tree: each module is drawn, fused and quantized
    before the next one is drawn, so the peak is the serving tree plus one
    float module. The draws come from ``init_params``' one generator in its
    order, so the result is bitwise the two-step build's."""
    tier = _mixture_tier(quantize_mixtures, bits, w8a8_mixtures)

    def mixture_fn(name: str, p: dict) -> dict:
        return tier(name, {**p, "layers": fuse_mixture_layers(p["layers"])})

    def siglip_fn(p: dict) -> dict:
        p = {**p, "layers": fuse_siglip_layers(p["layers"])}
        return _quantize_siglip(p) if w8a8_siglip else p

    init = pizero._Init(seed, resolve_device(device), dtype)
    return pizero._draw_params(cfg, init, mixture_fn=mixture_fn, siglip_fn=siglip_fn)
