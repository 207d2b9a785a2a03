"""Explicit collectives on the sub-groups of a DeviceMesh, each with the
backward that the sharded program needs (the Megatron / FSDP pairs).

The runtime keeps activations in one canonical layout: the batch split
over the data-parallel (dp) axes, every other dim whole on every rank of
the model (tp) axis.  Each tp rank then runs the same computation, except
inside a tp-split product, so a gradient that reaches a tp-replicated
tensor is the same on every tp rank; each dp rank runs its own rows, and
the train step's objective is the sum over dp ranks of each rank's part.
Under these two rules:

* :func:`gather` — all-gather along a dim; backward takes this rank's chunk
  of the (replicated) gradient.  The tp gather of a column-split product's
  output, of a seq-sharded attention output, of vocab-sharded logits, and
  of a tp-sharded parameter an op needs whole.
* :func:`split` — this rank's chunk along a dim; backward all-gathers.
* :func:`reduce` — all-reduce (sum); backward passes the gradient on.  The
  tp sum after a row-split product, the MoE's sum over the model axis, the
  dp sum of a loss whose backward each rank runs on its own part.
* :func:`copy` — identity; backward all-reduces.  The input of a tp-split
  product (each tp rank's gradient of it is a partial sum).
* :func:`fsdp_gather` — all-gather along a dim; backward reduce-scatters
  (sums over the group, keeps this rank's chunk).  The FSDP gather of a
  dp-sharded parameter at its use.
* :func:`sync_sum` — all-reduce both ways: a statistic every dp rank's
  objective reads (train-mode BatchNorm over the global batch).
* :func:`gather_over` — the rows every dp rank computed, whole on every
  rank (no autograd): the serving engine's state writes, which every rank
  applies to its whole copy of the state.

A ``None`` group or a group of one rank makes each of them the identity:
a one-rank mesh adds no collective to the program.  A bfloat16 sum runs
in float32.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    xc = x.contiguous()
    parts = [torch.empty_like(xc) for _ in range(group_size(group))]
    dist.all_gather(parts, xc, group=group)
    return torch.cat(parts, dim=dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.float().contiguous() if x.dtype == torch.bfloat16 \
        else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"evenly over {n} ranks")
    return x.chunk(n, dim=dim)[group_rank(group)].contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, group):
        fctx.dim, fctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(fctx, g):
        return _chunk(g, fctx.dim, fctx.group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, group):
        fctx.dim, fctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(fctx, g):
        return _all_gather(g, fctx.dim, fctx.group), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(fctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, group):
        fctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return _all_reduce(g, fctx.group), None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, group):
        fctx.dim, fctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(fctx, g):
        return _chunk(_all_reduce(g, fctx.group), fctx.dim, fctx.group), \
            None, None


class _SyncSum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, group):
        fctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(fctx, g):
        return _all_reduce(g, fctx.group), None


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _Gather.apply(x, dim % x.ndim, group)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _Split.apply(x, dim % x.ndim, group)


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _Reduce.apply(x, group)


def copy(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1 or not x.requires_grad:
        return x
    return _Copy.apply(x, group)


def fsdp_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _FsdpGather.apply(x, dim % x.ndim, group)


def sync_sum(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _SyncSum.apply(x, group)


# -- over several axes (a dp tuple) ------------------------------------------

def split_over(x: torch.Tensor, dim: int, groups: Sequence) -> torch.Tensor:
    """This rank's chunk along ``dim`` split over several axes, the first
    major (``PartitionSpec(("pod", "data"))``'s order)."""
    for g in groups:
        x = split(x, dim, g)
    return x


@torch.no_grad()
def gather_over(x: torch.Tensor, dim: int, groups: Sequence) -> torch.Tensor:
    """The inverse of :func:`split_over` (no autograd): the chunks along
    ``dim`` all-gathered over each group, the last (minor) first, so every
    rank holds the whole tensor in :func:`split_over`'s order."""
    for g in reversed(list(groups)):
        if group_size(g) > 1:
            x = _all_gather(x, dim % x.ndim, g)
    return x


def reduce_over(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    for g in groups:
        x = reduce(x, g)
    return x


def sync_sum_over(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    for g in groups:
        x = sync_sum(x, g)
    return x


@torch.no_grad()
def all_reduce_(x: torch.Tensor, groups: Sequence,
                op: Optional[dist.ReduceOp] = None) -> torch.Tensor:
    """In-place all-reduce of ``x`` over each group (no autograd)."""
    for g in groups:
        if group_size(g) > 1:
            y = x.float() if x.dtype == torch.bfloat16 else x
            dist.all_reduce(y, op=op or dist.ReduceOp.SUM, group=g)
            if y is not x:
                x.copy_(y)
    return x
