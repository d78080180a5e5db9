"""Model averaging: EMA / SWA (counterpart of the JAX package's
``training/averaging.py``; reference src/agent/model_averaging.py).

The average is a params tree updated after an optimizer update:

  EMA: avg <- decay * avg + (1-decay) * params     (every ``freq`` updates,
       starting at update ``start``; initialized to params at ``start``)
  SWA: avg <- (avg * n + params) / (n + 1)

The update count lives on the host, so whether an update is due is a
Python test, not a masked select.

Under ZeRO-1 (``shard_average``) each rank keeps its slice of every leaf's
average (``parallel.sharding.Zero1Shards``, flat) and blends it with the
same slice of the params: the rule is elementwise, so the slices are
bitwise those of the replicated average. ``eval_params`` and
``gathered`` put the leaves back together, collectively."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from open_pi_zero_torch.config import TrainingConfig
from open_pi_zero_torch.models.tree import tree_leaves, tree_map
from open_pi_zero_torch.parallel.sharding import Zero1Shards


@dataclass
class AveragingState:
    avg_params: dict  # same tree as params (under ZeRO-1: this rank's flat slice of each leaf)
    n_averaged: int
    shards: Optional[Zero1Shards] = None  # the ZeRO-1 layout; None when replicated


def _rebuild(tree: dict, leaves: list) -> dict:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


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

    if state.shards is not None:
        params = _rebuild(params, state.shards.local(params))
    return AveragingState(tree_map(blend, state.avg_params, params), state.n_averaged + 1, state.shards)


def shard_average(state: AveragingState, shards: Zero1Shards) -> AveragingState:
    """ZeRO-1: this rank's slice of each leaf of ``state``'s average in the
    layout ``shards`` of the params tree (copies: the full average can be
    freed)."""
    local = [x.clone() for x in shards.local(state.avg_params)]
    return AveragingState(_rebuild(state.avg_params, local), state.n_averaged, shards)


@torch.no_grad()
def load_average(state: AveragingState, avg_params: dict, n_averaged: int) -> AveragingState:
    """``state`` with the whole average ``avg_params`` copied into its
    tensors (under ZeRO-1, this rank's slices of it)."""
    src = avg_params if state.shards is None else _rebuild(avg_params, state.shards.local(avg_params))
    tree_map(lambda dst, x: dst.copy_(x), state.avg_params, src)
    return AveragingState(state.avg_params, n_averaged, state.shards)


def gathered(state: AveragingState, params: dict) -> dict:
    """The whole average (a collective under ZeRO-1; the state's own tree
    when replicated)."""
    if state.shards is None:
        return state.avg_params
    return _rebuild(params, state.shards.gather(tree_leaves(state.avg_params), params))


def eval_params(state: Optional[AveragingState], params: dict) -> dict:
    """The average if any snapshot was taken, else the live params
    (reference model_averaging.py:60-72). Under ZeRO-1 every rank of the
    data group calls it: the average is gathered."""
    if state is None or state.n_averaged == 0:
        return params
    return tree_map(lambda a, p: a.to(p.dtype), gathered(state, params), params)
