"""Rotary position embeddings in float32 (counterpart of the JAX package's
``ops/rope.py``).

Gemma RoPE: ``inv_freq = base^(-2i/dim)``; cos/sin over the full head dim
by concatenating the frequency table with itself; rotate_half splits the
head dim in two contiguous halves. Tables and rotation in fp32, cast at
the end. Layout ``[B, L, H, D]``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_cos_sin(
    position_ids: torch.Tensor,  # [B, L] or [L], integer or float positions
    head_dim: int,
    base: float,
    dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin) of shape [B, L, D] (or [L, D] if unbatched)."""
    exponents = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=position_ids.device)
        / head_dim
    )
    inv_freq = 1.0 / (base**exponents)  # [D/2]
    freqs = position_ids.to(torch.float32)[..., None] * inv_freq  # [..., L, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)  # [..., L, D]
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, L, H, D]; cos/sin: [B, L, D] or [L, D]. fp32 rotate, cast back."""
    if cos.dim() == 2:  # [L, D] -> broadcast batch
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].to(torch.float32)  # [B, L, 1, D]
    sin = sin[:, :, None, :].to(torch.float32)
    xf = x.to(torch.float32)
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)
