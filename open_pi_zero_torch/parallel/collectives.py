"""The collectives of a rank program (the JAX package leaves them to GSPMD).

Under ``nccl`` the tensors go to ``torch.distributed`` as they are. Under
``gloo``, which takes only some operations on CUDA tensors, a CUDA tensor
is staged through host memory explicitly: copied to the CPU, reduced or
gathered there, copied back. A group of one rank is a no-op.

``sum_row_parallel`` is the one all-reduce of the model itself: the
partial sums of a row-parallel projection (o, down, fc2) over the model
group. It is forward only: training runs on a data mesh (``n_model = 1``,
as the JAX TrainAgent's), where it returns its input; it raises on a
split kernel's output that requires grad.

Training's collectives: ``all_reduce_mean_``, the DP gradient all-reduce
(the trained leaves' grads packed into flat fp32 buckets, one collective
per bucket), and ``all_gather_ranges_``, which puts tensors back together
from the element ranges that each rank holds (ZeRO-1's updated param
slices, its moments and averages for a checkpoint).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

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


BUCKET_BYTES = 256 << 20  # a bucket of the packed collectives


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterator[List[int]]:
    """Indices of ``tensors`` in order, cut into runs of one dtype and at
    most ``BUCKET_BYTES`` (a larger tensor is a run of its own)."""
    run, size = [], 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if run and (size + nbytes > BUCKET_BYTES or t.dtype != tensors[run[0]].dtype):
            yield run
            run, size = [], 0
        run.append(i)
        size += nbytes
    if run:
        yield run


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Each tensor replaced by its mean over ``group``, in place: packed
    into flat fp32 buckets of at most ``BUCKET_BYTES`` (one all-reduce
    each), summed, divided by the group's size, unpacked."""
    n = _size(group)
    if n == 1:
        return
    as_fp32 = [t.reshape(-1).to(torch.float32) for t in tensors]  # views where they are fp32 already
    for run in _buckets(as_fp32):
        t = tensors[run[0]]
        if len(run) == 1 and t.dtype == torch.float32 and t.is_contiguous():  # a bucket of its own, no copy
            all_reduce(t, group).div_(n)
            continue
        flat = torch.cat([as_fp32[i] for i in run])
        all_reduce(flat, group).div_(n)
        offset = 0
        for i in run:
            t = tensors[i]
            t.copy_(flat[offset : offset + t.numel()].view(t.shape))
            offset += t.numel()


@torch.no_grad()
def all_gather_ranges_(
    tensors: Sequence[torch.Tensor], ranges: Sequence[Sequence[Tuple[int, int]]], group=None
) -> None:
    """Complete contiguous tensors in place from their ranks' parts:
    ``ranges[i][r]`` is the (lo, hi) flat element range of ``tensors[i]``
    that rank r of ``group`` holds; after the call every rank holds every
    range. The parts of one bucket travel in one all-gather, each rank's
    packed in order and padded to the longest rank's."""
    n = _size(group)
    if n == 1:
        return
    me = dist.get_rank(group)
    flats = [t.view(-1) for t in tensors]
    for run in _buckets(flats):
        sizes = [sum(ranges[i][r][1] - ranges[i][r][0] for i in run) for r in range(n)]
        width = max(sizes)
        if width == 0:
            continue
        mine = torch.zeros(width, dtype=flats[run[0]].dtype, device=flats[run[0]].device)
        offset = 0
        for i in run:
            lo, hi = ranges[i][me]
            mine[offset : offset + hi - lo] = flats[i][lo:hi]
            offset += hi - lo
        parts = all_gather(mine, group).view(n, width)
        for r in range(n):
            if r == me:
                continue
            offset = 0
            for i in run:
                lo, hi = ranges[i][r]
                flats[i][lo:hi] = parts[r, offset : offset + hi - lo]
                offset += hi - lo


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
        raise NotImplementedError("tensor-parallel training: the all-reduce has no backward (the JAX "
                                  "TrainAgent trains on a data mesh only)")
    return all_reduce(x, mesh.model_group)
