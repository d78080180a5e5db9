"""The training step (counterpart of the JAX package's
``training/train_step.py``): flow-matching loss -> grads -> dual-group
AdamW -> EMA/SWA, with gradient accumulation over microbatches.

The JAX step is a pure function that returns a new state; here
``step(state, batch)`` updates ``state`` in place (params, Adam moments,
update count, generator, average) and returns the metrics. A LoRA or QLoRA
tree trains the same way: its frozen leaves, the NF4 bases' integer
payloads among them, carry no ``requires_grad`` and get no grad, where
JAX differentiates them with ``allow_int`` and zeroes the integer tangents.
``TrainState`` is what ``training/checkpoint.py`` saves, the generator's
state included. Zero-1 and the mesh come with the multi-device slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from open_pi_zero_torch.config import PiZeroConfig, TrainingConfig
from open_pi_zero_torch.models import pizero
from open_pi_zero_torch.training import averaging as avg_lib
from open_pi_zero_torch.training.optimizer import Optimizer
from open_pi_zero_torch.training.sampling import sample_flow_time


@dataclass
class TrainState:
    params: dict
    opt_state: torch.optim.Optimizer  # AdamW or AdamW8bit over the trained leaves
    step: int  # number of optimizer updates applied
    generator: torch.Generator  # flow times and noise, on the params' device
    avg: Optional[avg_lib.AveragingState]  # EMA/SWA, None when disabled


def init_train_state(
    params: dict,
    optimizer: Optimizer,
    generator: torch.Generator,
    train_cfg: TrainingConfig,
) -> TrainState:
    """Marks the frozen leaves (``requires_grad=False``) and builds the
    optimizer state over the trained ones."""
    opt_state = optimizer.init(params)
    avg = avg_lib.init_averaging(params) if (train_cfg.use_ema or train_cfg.use_swa) else None
    return TrainState(params, opt_state, 0, generator, avg)


def batch_loss(
    params: dict, cfg: PiZeroConfig, generator: torch.Generator, batch: Dict[str, torch.Tensor]
) -> torch.Tensor:
    """Sample flow times + noise and evaluate the flow-matching MSE.
    batch: {input_ids, pixel_values, attention_mask, proprios, actions},
    tensors on the params' and the generator's device; optional ``t`` [B]
    and ``x0`` [B, A, act_dim] inject the flow times and the noise
    (tests/parity)."""
    actions = batch["actions"]
    t = batch.get("t")
    if t is None:
        t = sample_flow_time(generator, actions.shape[0], cfg)
    return pizero.flow_matching_loss(
        params, cfg, generator,
        batch["input_ids"], batch["pixel_values"], batch["attention_mask"],
        batch["proprios"], actions, t, x0=batch.get("x0"),
    )


def make_train_step(
    cfg: PiZeroConfig,
    train_cfg: TrainingConfig,
    optimizer: Optimizer,
    grad_accum: int = 1,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Returns step(state, batch) -> {"loss", "grad_norm"}.

    With grad_accum > 1 every batch tensor carries a leading [accum] axis;
    the loss and the grads are means over the microbatches (each
    microbatch's loss / grad_accum is backpropagated into the accumulated
    ``.grad``) before one optimizer update. ``grad_norm`` is the global
    norm after the freeze surgery and before the clip."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        state.opt_state.zero_grad(set_to_none=True)
        if grad_accum == 1:
            micro = [batch]
        else:
            micro = [{k: v[i] for k, v in batch.items()} for i in range(grad_accum)]
        loss = torch.zeros((), dtype=torch.float32, device=batch["actions"].device)
        for mb in micro:
            mb_loss = batch_loss(state.params, cfg, state.generator, mb)
            (mb_loss / grad_accum).backward()
            loss = loss + mb_loss.detach() / grad_accum
        grad_norm = optimizer.update(state.params, state.opt_state, state.step)
        state.step += 1
        if state.avg is not None:
            state.avg = avg_lib.maybe_update(state.avg, state.params, state.step, train_cfg)
        return {"loss": loss, "grad_norm": grad_norm}

    return step
