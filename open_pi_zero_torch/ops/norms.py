"""Normalization ops with the reference's precision semantics (counterpart
of the JAX package's ``ops/norms.py``).

Gemma's RMSNorm does all internal math in float32 and multiplies by
``(1 + w)`` before casting back. The adaLN variants are not ported yet:
the default config has ``action_expert_adaptive_mode=None``.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma RMSNorm: fp32 internals, (x_hat * (1 + w)) cast back to x.dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + weight.to(torch.float32))).to(x.dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Standard LayerNorm (SigLIP tower), fp32 internals."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)
