"""Normalization ops with the reference's precision semantics (counterpart
of the JAX package's ``ops/norms.py``).

Gemma's RMSNorm does all internal math in float32 and multiplies by
``(1 + w)`` before casting back. The adaLN variants keep JAX's cast points,
which differ from ``linear``'s single fp32 product: the normed x is cast
back to x's dtype, ``cond @ W`` comes out in cond's dtype (one rounding)
before the bias is added, and the sigmoid and ``normed * gamma + beta`` run
in that dtype. So their products are ``torch.matmul``, not
``ops/linear.matmul_f32``.
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


def _rms_only(x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


def _cond_proj(cond: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """[B, Dc] or [B, S, Dc] cond @ [Dc, D] kernel -> [B, 1 or S, D] in
    cond's dtype (JAX's ``einsum("bsc,cd->bsd", cond, kernel.astype(cond.dtype))``)."""
    if cond.dim() == 2:
        cond = cond[:, None, :]
    return torch.matmul(cond, kernel.to(cond.dtype))


def adaptive_rms_norm(
    x: torch.Tensor,
    cond: torch.Tensor,
    gamma_kernel: torch.Tensor,
    gamma_bias: torch.Tensor,
    beta_kernel: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """adaLN RMSNorm: norm(x) * sigmoid(cond @ Wg + bg) + cond @ Wb, with no
    (1 + w) weight; gamma and beta come from the time conditioning vector,
    broadcast over the sequence."""
    normed = _rms_only(x, eps)
    gamma = torch.sigmoid(_cond_proj(cond, gamma_kernel) + gamma_bias)
    beta = _cond_proj(cond, beta_kernel)
    return (normed * gamma + beta).to(x.dtype)


def adaptive_layerscale(
    x: torch.Tensor, cond: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """adaLN-Zero residual gate: x * sigmoid(cond @ W + b) (W starts at 0,
    b at -2)."""
    return x * torch.sigmoid(_cond_proj(cond, kernel) + bias).to(x.dtype)
