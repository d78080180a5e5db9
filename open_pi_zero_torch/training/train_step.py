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
state included.

Under a registered data mesh (``parallel.make_mesh`` with ``n_model = 1``,
the JAX TrainAgent's mesh) the step is data-parallel: each rank's batch is
its rows of the global batch, the microbatch grads accumulate locally and
are all-reduced (their mean over the data group) once per update, after
the accumulation, as JAX's GSPMD psum; the norm and the clip then see the
global-mean grads. Every rank draws the flow times and the noise of the
whole global microbatch from the train stream and keeps its rows, so the
DP update is the one-device update over the global batch (and a world of
one draws what it drew before). ``shard_state_zero1`` shards the moments
and the EMA/SWA average over the data ranks (ZeRO-1).

Under a (data, model) mesh the step is also tensor-parallel, as the JAX
package's ``make_train_step`` with ``shard_params_tp`` params: the state
holds the rank's TP shard (``parallel.shard_params_tp``, then
``init_train_state``: the moments and the average take the shard's shapes),
the ranks of one data index take the same rows and draw the same flow
times and noise, and the model's collectives carry the grads
(``parallel/collectives.py``): every rank ends the backward with its
slices' grads and the whole grads of the replicated leaves, bitwise alike
over the model group. The data group's all-reduce then runs on the rank's
own leaves, slices included; the global norm sums the slices' squares over
the model group (``optimizer.global_norm``), so every rank clips alike;
the replicated leaves stay bitwise equal over the model group. A LoRA
adapter's whole factor beside a split one (``parallel.sharding.
partial_grads``) ends the backward with this rank's part of its grad;
those grads are summed over the model group once per update, after the
accumulation, in packed buckets (``collectives.all_reduce_sum_``). QLoRA's
NF4 bases stay whole on every rank, frozen; int8 moments of a split leaf
are coded in the whole leaf's blocks (``AdamW8bit.split_over``). ZeRO-1
is refused under a model axis: the JAX package's ZeRO-1 places the params
replicated, so there is none over TP params to port. The TrainAgent stays
on a data mesh, as the JAX TrainAgent does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from open_pi_zero_torch.config import PiZeroConfig, TrainingConfig
from open_pi_zero_torch.models import pizero
from open_pi_zero_torch.models.tree import tree_leaves, tree_map
from open_pi_zero_torch.ops import lora as lora_lib
from open_pi_zero_torch.parallel import collectives
from open_pi_zero_torch.parallel.mesh import Mesh, get_mesh
from open_pi_zero_torch.parallel.sharding import Zero1Shards, partial_grads, tp_param_specs
from open_pi_zero_torch.training import averaging as avg_lib
from open_pi_zero_torch.training.optimizer import Optimizer, Zero1Optimizer
from open_pi_zero_torch.training.sampling import sample_flow_time


@dataclass
class TrainState:
    params: dict
    opt_state: torch.optim.Optimizer  # AdamW or AdamW8bit over the trained leaves (or a Zero1Optimizer)
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


def _rank_rows(draw: Callable[[int], torch.Tensor], b: int) -> torch.Tensor:
    """``draw(rows)`` for this rank's ``b`` rows: under a data mesh of n
    ranks every rank draws the global microbatch's n * b rows (its
    generator seeded alike) and keeps its own, so that the ranks' rows
    differ and together are one device's draw; else ``draw(b)``. The ranks
    of one data index (a model group) keep the same rows."""
    mesh = get_mesh()
    if mesh is None or mesh.n_data == 1:
        return draw(b)
    return draw(mesh.n_data * b)[mesh.data_index * b : (mesh.data_index + 1) * b]


def batch_loss(
    params: dict, cfg: PiZeroConfig, generator: torch.Generator, batch: Dict[str, torch.Tensor]
) -> torch.Tensor:
    """Sample flow times + noise and evaluate the flow-matching MSE.
    batch: {input_ids, pixel_values, attention_mask, proprios, actions},
    tensors on the params' and the generator's device (under a data mesh,
    this rank's rows); optional ``t`` [B] and ``x0`` [B, A, act_dim]
    inject the flow times and the noise (tests/parity)."""
    actions = batch["actions"]
    b = actions.shape[0]
    t = batch.get("t")
    if t is None:
        t = _rank_rows(lambda n: sample_flow_time(generator, n, cfg), b)
    x0 = batch.get("x0")
    if x0 is None:
        x0 = _rank_rows(lambda n: torch.randn((n, *actions.shape[1:]), generator=generator, device=t.device,
                                              dtype=t.dtype), b)
    return pizero.flow_matching_loss(
        params, cfg, generator,
        batch["input_ids"], batch["pixel_values"], batch["attention_mask"],
        batch["proprios"], actions, t, x0=x0,
    )


def tp_split(params: dict, cfg: PiZeroConfig, n_model: int) -> dict:
    """The spec tree over ``params`` (a rank's TP shard; a spec is truthy
    where the rank holds a slice of a leaf that ``n_model`` model ranks
    split): ``parallel.sharding.tp_param_specs`` of the config's whole
    tree, its LoRA adapters and NF4 bases included (``meta`` tensors)."""
    whole = lora_lib.quantize_per_model_config(pizero.abstract_params(cfg), cfg)
    return tree_map(lambda _, spec: spec, params, tp_param_specs(whole, cfg, n_model))


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
    norm after the freeze surgery and before the clip.

    Under a registered data mesh the batch is this rank's rows (axis 1
    when accumulated: ``parallel.shard_batch(mesh, batch, axis=1)``); the
    loss and the grads are all-reduced to their means over the data group
    before the update, so every rank returns the global metrics. Under a
    model axis the state holds the rank's TP shard and the norm is the
    whole tree's."""

    layouts = {}  # n_model -> (the spec tree, its partial grads' flags), made at the first TP step

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        mesh = get_mesh()
        split = partial = None
        if mesh is not None and mesh.n_model > 1:
            if mesh.n_model not in layouts:
                specs = tp_split(state.params, cfg, mesh.n_model)
                layouts[mesh.n_model] = specs, tree_leaves(partial_grads(specs))
            split, partial = layouts[mesh.n_model]
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
        if partial is not None:
            collectives.all_reduce_sum_([p.grad for p, part in zip(tree_leaves(state.params), partial)
                                         if part and p.grad is not None], mesh.model_group)
        if mesh is not None and mesh.n_data > 1:
            grads = [p.grad for p in tree_leaves(state.params) if p.grad is not None]
            collectives.all_reduce_mean_(grads + [loss], mesh.data_group)
        grad_norm = optimizer.update(state.params, state.opt_state, state.step, split, mesh)
        state.step += 1
        if state.avg is not None:
            state.avg = avg_lib.maybe_update(state.avg, state.params, state.step, train_cfg)
        return {"loss": loss, "grad_norm": grad_norm}

    return step


def zero1_shards(params: dict, mesh: Mesh) -> Zero1Shards:
    """ZeRO-1's layout of ``params``' leaves over the data axis of ``mesh``
    (the counterpart of ``zero1_state_sharding``): rank r's flat element
    range of each leaf, in whole blocks of 2048, which is its slice of that
    leaf's moments and of its average; the params themselves stay
    replicated."""
    return Zero1Shards(params, mesh)


def shard_state_zero1(state: TrainState, optimizer: Optimizer, mesh: Mesh) -> TrainState:
    """``state`` with its optimizer state and EMA/SWA average sharded over
    the data axis of ``mesh`` (ZeRO-1): a ``Zero1Optimizer`` over the slices
    of the trained leaves (``optimizer.make`` builds its inner state;
    moments that ``state`` holds already are sliced), and the average's
    slices. The params, the step and the generator stay replicated. A data
    axis of one returns ``state``, as in JAX."""
    if mesh.n_model > 1:
        raise NotImplementedError("ZeRO-1 under a model axis: the JAX package's zero1_state_sharding places the "
                                  "params replicated (open_pi_zero_tpu/training/train_step.py:154), so it has no "
                                  "ZeRO-1 over TP params to port; train on a data mesh")
    if mesh.n_data == 1:
        return state
    shards = zero1_shards(state.params, mesh)
    index = {id(x): i for i, x in enumerate(tree_leaves(state.params))}
    trained = [index[id(p)] for group in state.opt_state.param_groups for p in group["params"]]
    opt = Zero1Optimizer(state.opt_state, optimizer, shards.select(trained))
    avg = None if state.avg is None else avg_lib.shard_average(state.avg, shards)
    return TrainState(state.params, opt, state.step, state.generator, avg)
