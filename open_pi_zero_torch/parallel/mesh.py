"""The (data, model) mesh of processes (counterpart of the JAX package's
``parallel/mesh.py``).

JAX lays one program over a device mesh and lets GSPMD place the
collectives. The port runs one process per mesh position instead (rank =
data_index * n_model + model_index, as ``np.reshape(n_data, n_model)``
lays out JAX's devices), each holding its own shard: the batch is split
over ``data``, attention heads and MLP widths over ``model``, and the
collectives are written out (``parallel/collectives.py``).

``make_mesh`` builds this rank's ``Mesh`` (its coordinates and its two
process groups) and registers it, as JAX's ``make_mesh`` registers its
mesh for the fused attention: while a mesh with more than one rank is
registered, ``ops.attention.mot_attention`` sends every call to K1-shard,
the row-parallel projections all-reduce their partial sums over the model
group, and ``infer_action`` draws the global batch's noise and keeps its
rows.

``init_distributed`` joins a world that ``torchrun`` started (the
counterpart of ``jax.distributed.initialize``) and registers its data
mesh, for training: ``scripts/run.py --distributed``.

``run_ranks`` launches a rank program on every position of a mesh: a
``spawn`` start (CUDA cannot be forked once initialised), a ``file://``
rendezvous, a process-group timeout, and the collective backend decided up
front from where the ranks sit:
  - CPU ranks: ``gloo``;
  - CUDA ranks, each on its own card: ``nccl``;
  - CUDA ranks sharing cards (rank r on ``cuda:{r % cards}``): ``gloo``,
    with CUDA tensors staged through host memory by the collectives. NCCL
    refuses two ranks on one card.
If one rank raises, ``torch.multiprocessing.spawn`` ends the others and
raises in the caller; no rank is left waiting in a collective.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_MESH: Optional["Mesh"] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) mesh of processes.

    ``model_group`` holds the ranks of this data index (they share a batch
    shard and split the weights); ``data_group`` the ranks of this model
    index (they hold the same weight shard and split the batch)."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: Any
    model_group: Any
    backend: str
    device: torch.device

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def rank(self) -> int:
        return self.data_index * self.n_model + self.model_index

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Register the mesh this process runs under; None clears it."""
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


def world_size() -> int:
    """The processes of this run: the process group's size once one is
    initialized, else the launcher's ``WORLD_SIZE`` (1 when unset)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def process_index() -> int:
    """This process's rank: the process group's once one is initialized,
    else the launcher's ``RANK`` (0 when unset)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def make_mesh(
    n_data: int, n_model: int, device, timeout: Optional[datetime.timedelta] = None
) -> Mesh:
    """This rank's mesh over the initialised default process group, which
    must hold n_data * n_model ranks; registered as the current mesh.
    Every rank calls ``dist.new_group`` for every group, in one order.
    ``timeout`` bounds the groups' collectives (a new group does not take
    the default group's; None leaves torch's default)."""
    world = dist.get_world_size()
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} ranks")
    rank = dist.get_rank()
    data_index, model_index = divmod(rank, n_model)
    model_group = data_group = None
    for d in range(n_data):
        group = dist.new_group([d * n_model + m for m in range(n_model)], timeout=timeout)
        if d == data_index:
            model_group = group
    for m in range(n_model):
        group = dist.new_group([d * n_model + m for d in range(n_data)], timeout=timeout)
        if m == model_index:
            data_group = group
    mesh = Mesh(
        n_data, n_model, data_index, model_index, data_group, model_group,
        dist.get_backend(), torch.device(device),
    )
    set_mesh(mesh)
    return mesh


def shard_batch(mesh: Mesh, batch: dict, axis: int = 0) -> dict:
    """This data rank's rows of every leaf: the batch axis ``axis`` split
    evenly over ``data`` (1 for an accumulated batch, whose ``[accum]``
    axis leads: JAX's ``P(None, "data")``); the model ranks of one data
    index get the same rows."""

    def rows(x):
        b = x.shape[axis]
        if b % mesh.n_data:
            raise ValueError(f"batch {b} does not split over {mesh.n_data} data ranks")
        n = b // mesh.n_data
        return x.narrow(axis, mesh.data_index * n, n)

    return {k: rows(v) for k, v in batch.items()}


def broadcast_int(value: int) -> int:
    """Rank 0's ``value`` on every rank (the checkpoint a resume takes);
    ``value`` itself without a process group."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return int(value)
    nccl = dist.get_backend() == "nccl"  # takes CUDA tensors only
    device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    x = torch.tensor([int(value)], dtype=torch.int64, device=device)
    dist.broadcast(x, 0)
    return int(x[0])


TORCHRUN_VARIABLES = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device_type: str = "cuda") -> Mesh:
    """Join the world that ``torchrun`` started and register its data mesh,
    ``make_mesh(n_data=world, n_model=1)``: the counterpart of
    ``jax.distributed.initialize``. Reads ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` (the ``env://``
    rendezvous); rank r runs on ``cuda:{LOCAL_RANK % cards}`` or on the
    CPU; the backend is ``collective_backend``'s over the ranks of this
    host (``LOCAL_WORLD_SIZE``). Returns the mesh."""
    missing = [k for k in TORCHRUN_VARIABLES if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed: {', '.join(missing)} unset; launch with torchrun "
                           "(python -m torch.distributed.run --nproc_per_node N ...)")
    world, rank, local = (int(os.environ[k]) for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"))
    device = rank_device(device_type, local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = collective_backend(device.type, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
    return make_mesh(world, 1, device)


def shutdown_distributed() -> None:
    """Clear the registered mesh and leave the process group (a no-op
    without one)."""
    set_mesh(None)
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def rank_device(device_type: str, rank: int) -> torch.device:
    """Rank r's device: ``cuda:{r % cards}``, or the CPU. Raises when CUDA
    is asked for and there is no card."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: CUDA is not available")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank, world, n_data, n_model, device_type, backend, init_file,
               result_file, timeout_s, fn, args):
    device = rank_device(device_type, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host's cores
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=world, rank=rank, timeout=timeout
    )
    try:
        mesh = make_mesh(n_data, n_model, device, timeout)
        result = fn(mesh, *args)
        if rank == 0:
            torch.save(result, result_file)
        dist.barrier()
    finally:
        set_mesh(None)
        dist.destroy_process_group()


def collective_backend(device_type: str, world: int) -> str:
    """``nccl`` when every CUDA rank has a card of its own, else ``gloo``."""
    if device_type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def run_ranks(
    fn: Callable, n_data: int, n_model: int, *args, device: str = "cuda",
    timeout_s: float = 600.0,
):
    """Run ``fn(mesh, *args)`` in n_data * n_model spawned processes, one
    per mesh position, and return rank 0's result (it is saved with
    ``torch.save``: keep tensors in it on the CPU). ``fn`` lives in an
    importable module and the arguments pickle. ``timeout_s`` bounds every
    collective."""
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    world = n_data * n_model
    backend = collective_backend(device_type, world)
    with tempfile.TemporaryDirectory(prefix="opz_ranks_") as tmp:
        init_file, result_file = os.path.join(tmp, "rendezvous"), os.path.join(tmp, "result.pt")
        torch.multiprocessing.spawn(
            _rank_main,
            args=(world, n_data, n_model, device_type, backend, init_file, result_file,
                  timeout_s, fn, args),
            nprocs=world, join=True,
        )
        return torch.load(result_file, weights_only=False)
