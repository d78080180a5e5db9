"""SigLIP vision tower + multimodal projector (counterpart of the JAX
package's ``models/siglip.py``). A layer kernel may be a quantized dict
(``ops/linear.py``): the W8A8 tier of ``models/fuse.py``.

Patch embedding is a reshape + matmul on NHWC pixels (stride == kernel, so
the conv is a per-patch dense layer); pre-LN blocks with plain softmax MHA,
tanh-GELU MLP and a post-layernorm. The stacked ``[L, ...]`` layer params
are split into per-layer views once per call and walked by a Python loop.

Param tree (L = num layers):
  embeddings: patch: {kernel [P*P*C, D], bias [D]}, position: [N, D]
  layers:     ln1/ln2: {scale [L,D], bias [L,D]}
              attn:    q/k/v/o: {kernel [L,D,D], bias [L,D]}, or in the fused
                       serving layout qkv: {kernel [L,D,3D], bias [L,3D]} and o
              mlp:     fc1 {kernel [L,D,I], bias [L,I]}, fc2 {kernel [L,I,D], bias [L,D]}
  post_layernorm: {scale [D], bias [D]}
  projector:  {kernel [D, proj], bias [proj]}

Under tensor parallelism (``parallel/sharding.py``) a rank holds a slice
of the heads (q/k/v and their biases) and of the MLP width (fc1 and its
bias); the row-parallel o and fc2 all-reduce their partial sums over the
model group, and their biases, kept whole, are added once after it. Under
autograd the input of the split q/k/v and of fc1 sums its gradient over the
model group (``parallel.collectives.copy_to_model_group``), once for the
three heads' projections that share it. A LoRA adapter follows its base
(``parallel/sharding.py``), and a QLoRA NF4 base stays whole on every
rank: a split projection multiplies by its rank's slice of the decoded
kernel (``parallel/sharding.rank_kernel``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from open_pi_zero_torch.config import SiglipConfig
from open_pi_zero_torch.models.tree import layer_split
from open_pi_zero_torch.ops.attention import mha_attention
from open_pi_zero_torch.ops.linear import base_matmul, linear, lora_delta, out_features
from open_pi_zero_torch.ops.norms import layer_norm
from open_pi_zero_torch.parallel.collectives import copy_to_model_group, sum_row_parallel
from open_pi_zero_torch.parallel.sharding import model_ranks, rank_kernel


def patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, patch*patch*C] with per-patch (h, w, c) order."""
    b, h, w, c = pixel_values.shape
    gh, gw = h // patch, w // patch
    x = pixel_values.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, gh, gw, ph, pw, C]
    return x.reshape(b, gh * gw, patch * patch * c)


def _proj(
    group: dict, name: str, x: torch.Tensor, scaling: float, full_in: Optional[int] = None
) -> torch.Tensor:
    """LoRA-aware biased projection: the fp32 product plus the bias in fp32,
    cast once to x.dtype, as the JAX package's ``linear``, then the
    adapter's delta. With ``full_in`` (the kernel's whole input width) a
    row-parallel one: when its rows are split, the adapter's partial delta
    joins the kernel's partial sum before the one reduce over the model
    group, and the bias comes after it."""
    d = group[name]
    out = base_matmul(x, d["kernel"])
    lora = group.get(f"{name}_lora")
    if full_in is not None and x.shape[-1] != full_in:
        if lora is not None:
            out = out + lora_delta(x, lora, scaling)
        out = sum_row_parallel(out, x.shape[-1], full_in)
        return (out + d["bias"].to(torch.float32)).to(x.dtype)
    out = (out + d["bias"].to(torch.float32)).to(x.dtype)
    if lora is not None:
        out = (out.to(torch.float32) + lora_delta(x, lora, scaling)).to(x.dtype)
    return out


def _rank(group: dict, names: Tuple[str, ...], dim: int, split: bool, dtype) -> dict:
    """``group`` with the kernels of ``names`` as this rank multiplies by
    them (``rank_kernel``: a whole NF4 base of a split projection decoded
    and cut to the rank's slice)."""
    ranked = {n: {**group[n], "kernel": rank_kernel(group[n]["kernel"], dim, split, dtype)} for n in names}
    return group if all(ranked[n]["kernel"] is group[n]["kernel"] for n in names) else {**group, **ranked}


def _encoder_layer(x: torch.Tensor, lp: dict, cfg: SiglipConfig) -> torch.Tensor:
    b, n, _ = x.shape
    s = cfg.lora_scaling
    eps = cfg.layer_norm_eps
    tp = model_ranks()
    heads, width = cfg.num_attention_heads % tp == 0, cfg.intermediate_size % tp == 0
    h = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], eps)
    shape = (b, n, -1, cfg.head_dim)  # this rank's heads
    attn = lp["attn"]
    if "qkv" in attn:  # the fused serving layout (models/fuse.py)
        q, k, v = _proj(attn, "qkv", h, s).chunk(3, dim=-1)
    else:
        attn = _rank(attn, ("q", "k", "v"), -1, heads, h.dtype)
        h = copy_to_model_group(h, out_features(attn["q"]["kernel"]), cfg.hidden_size)  # q, k and v split alike
        q, k, v = (_proj(attn, name, h, s) for name in ("q", "k", "v"))
    q, k, v = q.reshape(shape), k.reshape(shape), v.reshape(shape)
    out = mha_attention(q, k, v).reshape(b, n, -1)
    x = x + _proj(_rank(attn, ("o",), -2, heads, out.dtype), "o", out, s, cfg.hidden_size)

    h = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], eps)
    mlp = _rank(_rank(lp["mlp"], ("fc1",), -1, width, h.dtype), ("fc2",), -2, width, h.dtype)
    h = copy_to_model_group(h, out_features(mlp["fc1"]["kernel"]), cfg.intermediate_size)
    h = F.gelu(_proj(mlp, "fc1", h, s), approximate="tanh")
    return x + _proj(mlp, "fc2", h, s, cfg.intermediate_size)


def forward(params: dict, cfg: SiglipConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """pixel_values: [B, H, W, C] normalized floats -> [B, N, D] features."""
    emb = params["embeddings"]
    x = linear(
        patchify(pixel_values, cfg.patch_size), emb["patch"]["kernel"], emb["patch"]["bias"]
    )
    x = x + emb["position"].to(x.dtype)
    for lp in layer_split(params["layers"], cfg.num_hidden_layers):
        x = _encoder_layer(x, lp, cfg)
    post = params["post_layernorm"]
    return layer_norm(x, post["scale"], post["bias"], cfg.layer_norm_eps)


def project(projector_params: dict, features: torch.Tensor, scaling: float = 1.0) -> torch.Tensor:
    """Multimodal projector: [B, N, D] -> [B, N, projection_dim]."""
    out = linear(features, projector_params["kernel"], projector_params["bias"])
    lora = projector_params.get("kernel_lora")
    if lora is not None:
        out = (out.to(torch.float32) + lora_delta(features, lora, scaling)).to(features.dtype)
    return out
