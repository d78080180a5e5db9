"""Flow-time embeddings (counterpart of the JAX package's ``ops/embeddings.py``)."""

from __future__ import annotations

import math

import torch


def sinusoidal_time_embedding(
    t: torch.Tensor, dim: int, max_period: float = 10000.0, dtype=None
) -> torch.Tensor:
    """[B] -> [B, dim]: concat(sin(t*f), cos(t*f)) with log-spaced freqs
    ``f_i = exp(-i * log(max_period)/(dim/2 - 1))``. Computed in fp32 and
    cast to ``dtype`` (or t.dtype)."""
    half = dim // 2
    out_dtype = dtype or t.dtype
    scale = math.log(max_period) / (half - 1)
    freqs = torch.exp(
        -scale * torch.arange(half, dtype=torch.float32, device=t.device)
    )  # [half]
    args = t.to(torch.float32)[:, None] * freqs[None, :]  # [B, half]
    return torch.cat([args.sin(), args.cos()], dim=-1).to(out_dtype)
