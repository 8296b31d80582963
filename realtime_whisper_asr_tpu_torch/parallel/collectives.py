"""The collectives of tensor and sequence parallelism, spelled out.

The JAX package lets XLA's SPMD partitioner insert its collectives from the
parameters' shardings. The port calls them itself: Megatron's region
functions, each a ``torch.autograd.Function`` whose backward is the
collective its forward's gradient needs, over one process group (a mesh's
model group):

- ``copy_to_tp``: forward the identity, backward an all-reduce (a replicated
  input consumed by a column-parallel linear: each rank's gradient is a
  partial sum);
- ``reduce_from_tp``: forward an all-reduce, backward the identity (a
  row-parallel product's partial sums);
- ``gather_from_tp``: forward an all-gather on the last dim, backward this
  rank's slice of it (a d-split embedding's rows);
- ``split_to_tp``: forward this rank's slice of the last dim, backward an
  all-gather (a replicated input to the d-split logits head);
- sequence parallelism on dim 1 (B, T, ...): ``all_gather_seq`` (forward an
  all-gather, backward a reduce-scatter: the input of a column-parallel
  linear) and ``reduce_scatter_seq`` (forward a reduce-scatter, backward an
  all-gather: a row-parallel output), each the other's backward;
  ``scatter_seq`` (forward this rank's positions, backward an all-gather)
  and ``gather_seq`` (forward an all-gather, backward this rank's
  positions) enter and leave the sequence-parallel region around
  replicated work;
- no-grad helpers: ``all_reduce_sum`` (int32 sums are exact),
  ``all_reduce_max`` and ``all_reduce_sum_`` (many tensors, in buckets).

Every tensor handed to a collective is contiguous, and so is every
result, in the layout the single-card path has at that point: a permuted
view would send the kernels downstream (cuDNN's, cuBLAS's) down other
algorithms, whose sums differ in the last bits. A collective's output is a
new tensor: its input may be saved by the autograd graph.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.autograd import Function

# torch 2.13 renamed these two (the old names warn); the card's torch has the old
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_into = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in rank order."""
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _all_gather(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's part along ``dim`` of the group's sum."""
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce-scatter of {src.shape[0]} rows over {n} ranks")
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _reduce_scatter_into(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's part along ``dim``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"{size} positions along dim {dim} do not split over {n} ranks")
    return x.narrow(dim, r * (size // n), size // n).contiguous()


class _CopyToTP(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _ReduceFromTP(Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(Function):
    """forward all-gather along ``dim``, backward this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group), None, None


class _Split(Function):
    """forward this rank's slice along ``dim``, backward an all-gather."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _AllGatherSeq(Function):
    """forward all-gather on dim 1, backward reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, 1, ctx.group), None


class _ReduceScatterSeq(Function):
    """forward reduce-scatter on dim 1, backward all-gather."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, 1, ctx.group), None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _Gather.apply(x, x.dim() - 1, group)


def split_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _Split.apply(x, x.dim() - 1, group)


def all_gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    return _AllGatherSeq.apply(x, group)


def reduce_scatter_seq(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceScatterSeq.apply(x, group)


def scatter_seq(x: torch.Tensor, group) -> torch.Tensor:
    return _Split.apply(x, 1, group)


def gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    return _Gather.apply(x, 1, group)


@torch.no_grad()
def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x`` as a new tensor (exact for integers)."""
    return _reduce(x, group)


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The group's elementwise maximum of ``x`` as a new tensor."""
    return _reduce(x, group, dist.ReduceOp.MAX)


#: elements of one all-reduce bucket of ``all_reduce_sum_`` (128 MiB of f32)
BUCKET_ELEMS = 1 << 25


@torch.no_grad()
def all_reduce_sum_(tensors: list, group) -> None:
    """Replace each tensor by the group's sum of it, in place: one
    all-reduce per bucket of at most ``BUCKET_ELEMS`` elements of one dtype
    (a larger tensor has a bucket of its own)."""
    bucket: list = []

    def flush():
        if not bucket:
            return
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()
        bucket.clear()

    size = 0
    for t in tensors:
        if bucket and (size + t.numel() > BUCKET_ELEMS or t.dtype != bucket[0].dtype):
            flush()
            size = 0
        bucket.append(t)
        size += t.numel()
    flush()
