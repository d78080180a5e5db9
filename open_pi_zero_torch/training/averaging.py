"""Model averaging: EMA / SWA (counterpart of the JAX package's
``training/averaging.py``; reference src/agent/model_averaging.py).

The average is a params tree updated after an optimizer update:

  EMA: avg <- decay * avg + (1-decay) * params     (every ``freq`` updates,
       starting at update ``start``; initialized to params at ``start``)
  SWA: avg <- (avg * n + params) / (n + 1)

The update count lives on the host, so whether an update is due is a
Python test, not a masked select."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from open_pi_zero_torch.config import TrainingConfig
from open_pi_zero_torch.models.tree import tree_map


@dataclass
class AveragingState:
    avg_params: dict  # same tree as params
    n_averaged: int


def init_averaging(params: dict) -> AveragingState:
    return AveragingState(tree_map(lambda p: torch.zeros_like(p, requires_grad=False), params), 0)


@torch.no_grad()
def maybe_update(
    state: AveragingState, params: dict, update_idx: int, cfg: TrainingConfig
) -> AveragingState:
    """Apply the EMA/SWA rule if update ``update_idx`` is due. No-op when
    neither mode is enabled."""
    if not (cfg.use_ema or cfg.use_swa):
        return state
    start = cfg.ema_start if cfg.use_ema else cfg.swa_start
    freq = cfg.ema_freq if cfg.use_ema else cfg.swa_freq
    if update_idx < start or (update_idx - start) % freq:
        return state

    def blend(avg, p):
        if not avg.is_floating_point():
            # integer leaves (QLoRA's frozen NF4 / int8 payloads) are not
            # averaged: blending would promote them to float
            return p.detach()
        p = p.detach().to(avg.dtype)
        if cfg.use_ema:
            d = 0.0 if state.n_averaged == 0 else cfg.ema_decay
            return d * avg + (1.0 - d) * p
        return (avg * state.n_averaged + p) / (state.n_averaged + 1.0)

    return AveragingState(tree_map(blend, state.avg_params, params), state.n_averaged + 1)


def eval_params(state: Optional[AveragingState], params: dict) -> dict:
    """The average if any snapshot was taken, else the live params
    (reference model_averaging.py:60-72)."""
    if state is None or state.n_averaged == 0:
        return params
    return tree_map(lambda a, p: a.to(p.dtype), state.avg_params, params)
