"""The collectives of a rank program (the JAX package leaves them to GSPMD).

Under ``nccl`` the tensors go to ``torch.distributed`` as they are. Under
``gloo``, which takes only some operations on CUDA tensors, a CUDA tensor
is staged through host memory explicitly: copied to the CPU, reduced or
gathered there, copied back. A group of one rank is a no-op.

``sum_row_parallel`` is the one all-reduce of the model itself: the
partial sums of a row-parallel projection (o, down, fc2) over the model
group. It is forward only: training under a mesh is not ported, and it
raises on a tensor that requires grad.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from open_pi_zero_torch.parallel.mesh import get_mesh


def _size(group) -> int:
    return dist.get_world_size(group)


def _staged(x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend() == "gloo"


def all_reduce(x: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``group`` in place; returns it."""
    if _size(group) == 1:
        return x
    if _staged(x):
        host = x.cpu()
        dist.all_reduce(host, op=op, group=group)
        x.copy_(host)
    else:
        dist.all_reduce(x, op=op, group=group)
    return x


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x``, concatenated along ``dim`` in the group's rank
    order."""
    n = _size(group)
    if n == 1:
        return x
    src = x.detach().contiguous()
    if _staged(src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def sum_row_parallel(x: torch.Tensor, local_in: int, full_in: int) -> torch.Tensor:
    """The output of a projection whose kernel holds ``local_in`` of its
    ``full_in`` input rows: a partial sum when the rows were split over the
    model group, all-reduced there; ``x`` itself when they were not."""
    if local_in == full_in:
        return x
    mesh = get_mesh()
    if mesh is None or mesh.n_model * local_in != full_in:
        raise ValueError(
            f"a row-parallel kernel holds {local_in} of {full_in} input rows "
            f"under mesh {None if mesh is None else mesh.shape}"
        )
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("training under a mesh is not ported: the all-reduce has no backward")
    return all_reduce(x, mesh.model_group)
