"""Action accuracy metric (counterpart of the JAX package's
``utils/metric.py``; reference src/utils/metric.py:6-21): the share of
(batch x horizon) samples whose action dims are ALL within the threshold."""

from __future__ import annotations

from typing import Sequence

import torch


def get_action_accuracy(
    gt: torch.Tensor,  # [B, H, A]
    pred: torch.Tensor,
    thresholds: Sequence[float] = (0.1, 0.2),
) -> torch.Tensor:
    """[len(thresholds)] fp32 accuracies."""
    diff = (gt - pred).abs().reshape(-1, gt.shape[-1])
    return torch.stack([(diff < th).all(dim=1).to(torch.float32).mean() for th in thresholds])


def l1_loss(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Mean absolute error, the reference's validation loss (train.py:437)."""
    return (gt - pred).abs().mean()
