"""The collectives of a rank program (the JAX package leaves them to GSPMD).

Under ``nccl`` the tensors go to ``torch.distributed`` as they are. Under
``gloo``, which takes only some operations on CUDA tensors, a CUDA tensor
is staged through host memory explicitly: copied to the CPU, reduced or
gathered there, copied back. A group of one rank is a no-op.

The model's own collectives are Megatron's two operators over the model
group, autograd-aware, so that a train step runs under tensor parallelism:
  - ``sum_row_parallel``, the output of a row-parallel projection (o, down,
    fc2): the ranks' partial sums all-reduced in the forward; the identity
    in the backward, where every rank holds the whole cotangent of the
    replicated output (``torch.distributed.nn.all_reduce`` would all-reduce
    it again and count the gradient tp times);
  - ``copy_to_model_group``, the input of a column-parallel projection that
    is split (q, k/v when their heads split, gate/up, SigLIP's q/k/v and
    fc1): the identity in the forward; in the backward each rank's input
    gradient is the partial sum over its output columns, all-reduced. It
    goes on the input of a split projection only: where K/V are replicated
    (one KV head), K1-shard's VJP sums dk and dv over the model group
    already, so the K/V path's input gradient is whole on every rank.
Without autograd (inference) the first all-reduces in place and the second
returns its input.

Training's collectives: ``all_reduce_mean_``, the DP gradient all-reduce
(the trained leaves' grads packed into flat fp32 buckets, one collective
per bucket), ``all_reduce_sum_``, the same packing for the grads that TP
leaves partial on each rank (a LoRA adapter's whole factor beside a split
one, ``parallel/sharding.partial_grads``), and ``all_gather_ranges_``, which puts tensors back together
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
    _all_reduce_packed_(tensors, group, mean=True)


@torch.no_grad()
def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Each tensor replaced by its sum over ``group``, in place, packed as
    ``all_reduce_mean_`` packs."""
    _all_reduce_packed_(tensors, group, mean=False)


def _all_reduce_packed_(tensors: Sequence[torch.Tensor], group, mean: bool) -> None:
    n = _size(group)
    if n == 1:
        return
    as_fp32 = [t.reshape(-1).to(torch.float32) for t in tensors]  # views where they are fp32 already
    for run in _buckets(as_fp32):
        t = tensors[run[0]]
        if len(run) == 1 and t.dtype == torch.float32 and t.is_contiguous():  # a bucket of its own, no copy
            all_reduce(t, group)
            if mean:
                t.div_(n)
            continue
        flat = all_reduce(torch.cat([as_fp32[i] for i in run]), group)
        if mean:
            flat.div_(n)
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


def _model_group(local: int, full: int, what: str):
    """The registered mesh's model group, over whose ranks ``full`` rows or
    columns (``what``) of a kernel are split ``local`` to a rank."""
    mesh = get_mesh()
    if mesh is None or mesh.n_model * local != full:
        raise ValueError(f"a kernel holds {local} of {full} {what} under mesh {None if mesh is None else mesh.shape}")
    return mesh.model_group


def _under_autograd(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


class _ReduceForward(torch.autograd.Function):
    """All-reduce in the forward, the identity in the backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ReduceBackward(torch.autograd.Function):
    """The identity in the forward, all-reduce in the backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


def sum_row_parallel(x: torch.Tensor, local_in: int, full_in: int) -> torch.Tensor:
    """The output of a projection whose kernel holds ``local_in`` of its
    ``full_in`` input rows: a partial sum when the rows were split over the
    model group, all-reduced there (the backward is the identity); ``x``
    itself when they were not."""
    if local_in == full_in:
        return x
    group = _model_group(local_in, full_in, "input rows")
    if _under_autograd(x):
        return _ReduceForward.apply(x, group)
    return all_reduce(x, group)


def copy_to_model_group(x: torch.Tensor, local_out: int, full_out: int) -> torch.Tensor:
    """``x`` as the input of a projection of ``full_out`` output columns,
    ``local_out`` of them computed on this rank: when that is a slice (a
    split over the model group), ``x`` with its gradient all-reduced there
    in the backward; ``x`` itself when the rank computes them all or
    without autograd. The rank's column count decides, not the kernel's
    type: a quantized base stays whole on every rank and its split
    projection multiplies by a slice of its decoded kernel
    (``parallel/sharding.rank_kernel``)."""
    if local_out == full_out:
        return x
    group = _model_group(local_out, full_out, "output columns")
    if _under_autograd(x):
        return _ReduceBackward.apply(x, group)
    return x
