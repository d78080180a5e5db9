"""LR schedule as a pure function of the update count (counterpart of the
JAX package's ``training/schedules.py``).

Reference: CosineAnnealingWarmupRestarts (src/utils/optim.py:31-159) — linear
warmup from min_lr to max_lr over ``warmup_steps``, then cosine anneal to
min_lr over the rest of the cycle, restarting every ``first_cycle_steps``
with max_lr scaled by ``gamma`` per cycle. The optimizer sets each group's
lr from it before every update, the first update taking ``schedule(0)`` as
optax does."""

from __future__ import annotations

import math
from typing import Callable

from open_pi_zero_torch.config import LRSchedulerConfig


def cosine_annealing_warmup_restarts(
    max_lr: float,
    first_cycle_steps: int,
    min_lr: float = 1e-8,
    warmup_steps: int = 0,
    cycle_mult: float = 1.0,
    gamma: float = 1.0,
) -> Callable[[int], float]:
    """Returns schedule(count) -> lr. Only cycle_mult == 1.0 is supported
    (every reference config uses 1.0)."""
    if cycle_mult != 1.0:
        raise NotImplementedError("cycle_mult != 1.0 is not used by any config")
    if not warmup_steps < first_cycle_steps:
        raise ValueError(f"warmup_steps {warmup_steps} >= first_cycle_steps {first_cycle_steps}")

    def schedule(count: int) -> float:
        cycle = math.floor(count / first_cycle_steps)
        step_in_cycle = count - cycle * first_cycle_steps
        cur_max = max_lr * gamma**cycle
        if step_in_cycle < warmup_steps:
            return (cur_max - min_lr) * step_in_cycle / max(warmup_steps, 1) + min_lr
        phase = math.pi * (step_in_cycle - warmup_steps) / (first_cycle_steps - warmup_steps)
        return min_lr + (cur_max - min_lr) * (1.0 + math.cos(phase)) / 2.0

    return schedule


def from_config(max_lr: float, cfg: LRSchedulerConfig) -> Callable[[int], float]:
    return cosine_annealing_warmup_restarts(
        max_lr=max_lr,
        first_cycle_steps=cfg.first_cycle_steps,
        min_lr=cfg.min_lr,
        warmup_steps=cfg.warmup_steps,
        cycle_mult=cfg.cycle_mult,
        gamma=cfg.gamma,
    )
