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
three heads' projections that share it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from open_pi_zero_torch.config import SiglipConfig
from open_pi_zero_torch.models.tree import layer_split
from open_pi_zero_torch.ops.attention import mha_attention
from open_pi_zero_torch.ops.linear import base_matmul, linear, lora_delta
from open_pi_zero_torch.ops.norms import layer_norm
from open_pi_zero_torch.parallel.collectives import copy_to_model_group, sum_row_parallel


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
    cast once to x.dtype, as the JAX package's ``linear``. With ``full_in``
    (the kernel's whole input width) a row-parallel one: its fp32 partial
    sums are reduced over the model group before the bias."""
    d = group[name]
    out = base_matmul(x, d["kernel"])
    if full_in is not None:
        out = sum_row_parallel(out, x.shape[-1], full_in)
    out = (out + d["bias"].to(torch.float32)).to(x.dtype)
    lora = group.get(f"{name}_lora")
    if lora is not None:
        out = (out.to(torch.float32) + lora_delta(x, lora, scaling)).to(x.dtype)
    return out


def _encoder_layer(x: torch.Tensor, lp: dict, cfg: SiglipConfig) -> torch.Tensor:
    b, n, _ = x.shape
    s = cfg.lora_scaling
    eps = cfg.layer_norm_eps
    h = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], eps)
    shape = (b, n, -1, cfg.head_dim)  # this rank's heads
    if "qkv" in lp["attn"]:  # the fused serving layout (models/fuse.py)
        q, k, v = _proj(lp["attn"], "qkv", h, s).chunk(3, dim=-1)
    else:
        h = copy_to_model_group(h, lp["attn"]["q"]["kernel"], cfg.hidden_size)  # q, k and v split alike
        q, k, v = (_proj(lp["attn"], name, h, s) for name in ("q", "k", "v"))
    q, k, v = q.reshape(shape), k.reshape(shape), v.reshape(shape)
    attn = mha_attention(q, k, v).reshape(b, n, -1)
    x = x + _proj(lp["attn"], "o", attn, s, cfg.hidden_size)

    h = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], eps)
    h = copy_to_model_group(h, lp["mlp"]["fc1"]["kernel"], cfg.intermediate_size)
    h = F.gelu(_proj(lp["mlp"], "fc1", h, s), approximate="tanh")
    return x + _proj(lp["mlp"], "fc2", h, s, cfg.intermediate_size)


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
