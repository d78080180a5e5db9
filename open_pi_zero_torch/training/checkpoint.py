"""Checkpoints on ``torch.save`` (counterpart of the JAX package's
``training/checkpoint.py``; reference src/agent/train.py:497-560).

The JAX package writes orbax directories, which the card's machine cannot
read (no orbax, no tensorstore): the port keeps JAX's layout and semantics
in its own format (ROADMAP.md §3, deliberate differences). A checkpoint
directory holds

  state/state.pt     the whole TrainState: the params, the optimizer's
                     ``state_dict`` (Adam moments, int8 payloads and their
                     scales under AdamW8bit, each group's count), the update
                     count, the generator's state and the EMA/SWA average
  params/params.pt   the eval export (``averaging.eval_params``) that
                     serving loads (``restore_params``), when given
  meta.json          host metadata (cnt_batch, wandb_id, ``world_size`` when
                     more than one process wrote it, and ``quant_layout_version``
                     when the params carry quantized bases), written last,
                     through a temporary file and ``os.replace``: a
                     directory without it is incomplete

A run on a data mesh saves the same one-device format, collectively (the
JAX agent's save is a collective too): every rank calls
``save_checkpoint``; under ZeRO-1 the moment and average slices are
gathered; rank 0 writes, the others wait at a barrier. ``restore_checkpoint``
reads the one-device format on every rank and keeps each rank's slices, so
a checkpoint of n ranks resumes on m.

Each ``.pt`` is also written to a temporary name and renamed, and read
with ``torch.load(weights_only=True)``: tensors, dicts, lists and numbers
only. The schedules are functions of the update count and need no state.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from open_pi_zero_torch import resolve_device
from open_pi_zero_torch.models.tree import tree_map
from open_pi_zero_torch.ops.lora import has_quantized_bases
from open_pi_zero_torch.ops.quantization import QUANT_LAYOUT_VERSION
from open_pi_zero_torch.parallel.mesh import process_index, world_size
from open_pi_zero_torch.training import averaging as avg_lib
from open_pi_zero_torch.training.optimizer import Zero1Optimizer
from open_pi_zero_torch.training.train_step import TrainState

STATE_DIR = "state"
PARAMS_DIR = "params"
META_FILE = "meta.json"
STATE_FILE = "state.pt"
PARAMS_FILE = "params.pt"


def _save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _write_meta(path: str, meta: dict) -> None:
    tmp = os.path.join(path, META_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(path, META_FILE))


def _read_meta(path: str) -> dict:
    meta_path = os.path.join(path, META_FILE)
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def _detached(tree):
    return tree_map(lambda t: t.detach(), tree)


def _quant_meta(params) -> dict:
    """The 4-bit payload's layout version, stamped when the tree carries
    quantized bases: a payload packed otherwise would restore without a
    structural error and dequantize to scrambled weights."""
    return {"quant_layout_version": QUANT_LAYOUT_VERSION} if has_quantized_bases(params) else {}


def _check_quant_meta(params, extra: dict, path: str) -> None:
    if not has_quantized_bases(params):
        return
    got = extra.get("quant_layout_version")
    if got != QUANT_LAYOUT_VERSION:
        raise ValueError(
            f"checkpoint {path} carries quantized bases with packing layout version {got!r}, but this "
            f"code expects {QUANT_LAYOUT_VERSION}: dequantizing would scramble the weights. Re-quantize "
            "from the float checkpoint (ops.lora.quantize_per_model_config)."
        )


def _check_tree(want, got, where: str = "") -> None:
    """Raise ValueError unless ``got`` has ``want``'s keys, shapes and dtypes."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(want) != set(got):
            theirs = sorted(got) if isinstance(got, dict) else type(got).__name__
            raise ValueError(f"checkpoint tree at {where or '/'}: keys {theirs}, want {sorted(want)}")
        for k in want:
            _check_tree(want[k], got[k], f"{where}/{k}")
    elif tuple(want.shape) != tuple(got.shape) or want.dtype != got.dtype:
        raise ValueError(
            f"checkpoint leaf {where}: {tuple(got.shape)} {got.dtype}, want {tuple(want.shape)} {want.dtype}"
        )


def _check_opt_state(opt: torch.optim.Optimizer, saved: dict, path: str) -> None:
    """Raise ValueError unless the optimizer holds every saved state tensor
    at its saved shape and dtype (the int8 moments of AdamW8bit stay int8)."""
    loaded = opt.state_dict()["state"]
    for i, st in saved["state"].items():
        for k, v in st.items():
            got = loaded.get(i, {}).get(k)
            if torch.is_tensor(v) and (got is None or got.dtype != v.dtype or got.shape != v.shape):
                theirs = None if got is None else f"{tuple(got.shape)} {got.dtype}"
                raise ValueError(f"checkpoint {path}: optimizer state {i}/{k} loaded as {theirs}, "
                                 f"saved as {tuple(v.shape)} {v.dtype}")


@torch.no_grad()
def _copy_into(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


def save_checkpoint(
    path: str, state: TrainState, extra: Optional[dict] = None, eval_params: Optional[dict] = None
) -> None:
    """Write ``state`` under ``path/state/`` and, when given, ``eval_params``
    under ``path/params/`` (the same directory then feeds both resuming and
    serving), then ``meta.json`` with ``extra`` as the completion marker.
    An existing checkpoint at ``path`` is overwritten. In a world of more
    than one process every rank calls it: rank 0 writes the one-device
    format (the ZeRO-1 slices gathered first, a collective), the others
    wait at a barrier."""
    path = os.path.abspath(path)
    world = world_size()
    opt_state = state.opt_state.state_dict()  # gathered under ZeRO-1
    avg = state.avg
    avg = None if avg is None else {"avg_params": _detached(avg_lib.gathered(avg, state.params)),
                                    "n_averaged": avg.n_averaged}
    if process_index() == 0:
        os.makedirs(os.path.join(path, STATE_DIR), exist_ok=True)
        _save(
            {
                "params": _detached(state.params),
                "opt_state": opt_state,
                "step": int(state.step),
                "generator": state.generator.get_state(),
                "avg": avg,
            },
            os.path.join(path, STATE_DIR, STATE_FILE),
        )
        if eval_params is not None:
            os.makedirs(os.path.join(path, PARAMS_DIR), exist_ok=True)
            _save(_detached(eval_params), os.path.join(path, PARAMS_DIR, PARAMS_FILE))
        ranks = {"world_size": world} if world > 1 else {}  # absent: one process
        _write_meta(path, {**(extra or {}), **ranks, **_quant_meta(state.params)})
    if world > 1:
        dist.barrier()


def restore_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, dict]:
    """Restore the checkpoint at ``path`` into ``state`` (from
    ``init_train_state`` on the same tree and optimizer: its structure,
    shapes and dtypes must match, else ValueError), in place: the params
    and the average are copied into their tensors, which the optimizer
    holds; under ZeRO-1 (``train_step.shard_state_zero1``) each rank keeps
    its slices of the moments and the average, whatever world size wrote
    the checkpoint. Returns (state, the metadata)."""
    path = os.path.abspath(path)
    saved = torch.load(os.path.join(path, STATE_DIR, STATE_FILE), map_location="cpu", weights_only=True, mmap=True)
    extra = _read_meta(path)
    _check_tree(state.params, saved["params"], "params")
    _check_quant_meta(saved["params"], extra, path)
    if (state.avg is None) != (saved["avg"] is None):
        raise ValueError(f"checkpoint {path}: EMA/SWA average {'absent' if saved['avg'] is None else 'present'}, "
                         "unlike the state restored into")
    _copy_into(state.params, saved["params"])
    opt, opt_saved = state.opt_state, saved["opt_state"]
    if isinstance(opt, Zero1Optimizer):
        opt, opt_saved = opt.inner, opt.shard_state_dict(opt_saved)
    opt.load_state_dict(opt_saved)
    _check_opt_state(opt, opt_saved, path)
    state.step = int(saved["step"])
    state.generator.set_state(saved["generator"])
    if state.avg is not None:
        _check_tree(state.params if state.avg.shards is not None else state.avg.avg_params,
                    saved["avg"]["avg_params"], "avg")
        state.avg = avg_lib.load_average(state.avg, saved["avg"]["avg_params"], int(saved["avg"]["n_averaged"]))
    return state, extra


def is_checkpoint(path: str) -> bool:
    """True if ``path`` is a directory in this module's format."""
    return os.path.exists(os.path.join(path, PARAMS_DIR, PARAMS_FILE)) or os.path.exists(
        os.path.join(path, STATE_DIR, STATE_FILE)
    )


def restore_params(path: str, abstract_params: Optional[dict] = None, device="cuda") -> dict:
    """The params exported at ``path`` on ``device`` (CUDA by default;
    raises without a card unless ``device='cpu'``). With
    ``abstract_params`` (real or ``meta`` tensors) the tree must match its
    structure, shapes and dtypes. A directory with a TrainState but no
    eval export raises FileNotFoundError."""
    path = os.path.abspath(path)
    device = resolve_device(device)
    if not os.path.exists(os.path.join(path, PARAMS_DIR)) and os.path.exists(os.path.join(path, STATE_DIR)):
        raise FileNotFoundError(
            f"checkpoint {path} holds a full TrainState ('{STATE_DIR}/') but no eval-params export "
            f"('{PARAMS_DIR}/'): load it with restore_checkpoint(...) and take "
            "averaging.eval_params(state.avg, state.params), or save it again with eval_params"
        )
    params = torch.load(os.path.join(path, PARAMS_DIR, PARAMS_FILE), map_location="cpu", weights_only=True)
    if abstract_params is not None:
        _check_tree(abstract_params, params, "params")
    extra: dict[str, Any] = _read_meta(path)
    _check_quant_meta(params, extra, path)
    return tree_map(lambda t: t.to(device), params)
