"""Collectives with autograd, the gradient mean, and the replica check.

Port of `gnerf_tpu/parallel/collectives.py`, with the differentiable
collectives that JAX gets from tracing one global program.

Every collective is built on `all_reduce` and `broadcast` alone: gloo runs
only these two on CUDA tensors, and two gloo ranks sharing one card is how
the distributed path is checked on a single H100.

Gradient convention. A distributed step differentiates, on each rank, that
rank's own loss; the objective the ranks compute together is the sum of
their losses. `all_reduce` and `all_gather` therefore take their adjoint as
backward: the upstream gradients of every rank are summed (an `all_reduce`
of the gradients), and `all_gather` keeps the rank's own slot of that sum.
A loss that depends on another rank's rows (a BatchNorm moment, a
minibatch-std group) so sends that rank its share of the gradient, and the
sum over ranks of the parameter gradients is the gradient of the sum of the
losses. A loss computed identically on k ranks thus gets k times its
gradient on each of them; `pmean_grads` over those ranks divides it out.
Each backward is itself made of these Functions, so it is differentiable
again (R1 runs under `create_graph=True`).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.profiling import span


def _size(group) -> int:
    return dist.get_world_size(group)


class _AllReduce(torch.autograd.Function):
    """y = scale * (the sum of x over the group's ranks); backward: the
    same reduction of the upstream gradients."""

    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.group, ctx.scale = group, scale
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y if scale == 1 else y * scale

    @staticmethod
    def backward(ctx, grad):
        return _AllReduce.apply(grad, ctx.group, ctx.scale), None, None


class _AllGather(torch.autograd.Function):
    """y = the ranks' x concatenated along `dim` in group-rank order (an
    all_reduce of a zeroed buffer in which each rank fills its own slot);
    backward: the sum of the upstream gradients over the ranks, at this
    rank's slot."""

    @staticmethod
    def forward(ctx, x, group, dim):
        rank, n = dist.get_rank(group), x.shape[dim]
        ctx.group, ctx.dim, ctx.rank, ctx.n = group, dim, rank, n
        shape = list(x.shape)
        shape[dim] = n * _size(group)
        buf = x.new_zeros(shape)
        buf.narrow(dim, rank * n, n).copy_(x)
        dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        total = _AllReduce.apply(grad, ctx.group, 1)
        return total.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def all_reduce(x: torch.Tensor, group, mean: bool = False) -> torch.Tensor:
    """Sum (or mean) of x over the group's ranks, differentiable."""
    return _AllReduce.apply(x, group, 1.0 / _size(group) if mean else 1)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's x, concatenated along `dim` in group-rank order,
    differentiable."""
    return _AllGather.apply(x, group, dim)


def pmean_grads(grads: Sequence[Optional[torch.Tensor]], group) -> list:
    """Cross-rank gradient mean with NaN / Inf scrubbing: the semantics of
    the reference's flat-buffer all_reduce + nan_to_num
    (`training_loop.py:388-396`). The gradients are summed in one flat
    buffer per dtype, divided by the group's size, and only then scrubbed,
    so a NaN on one rank zeroes that element on every rank. `group` None
    (a single process) only scrubs. Returns the gradients in order, None
    where a gradient was None."""
    out: list = list(grads)
    by_dtype: dict = {}
    for i, g in enumerate(grads):
        if g is not None:
            by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        if group is not None:
            with span("ddp.allreduce"):
                dist.all_reduce(flat, group=group)
                flat.div_(_size(group))
        torch.nan_to_num_(flat, nan=0.0, posinf=1e5, neginf=-1e5)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


def psum_moments(value: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group's ranks of a vector of moments, such as an
    [n, sum, sum_sq] triple, without a gradient: the training-stats sync
    (reference `torch_utils/training_stats.py` _sync)."""
    out = value.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def check_replica_consistency(named: Iterable[tuple[str, torch.Tensor]], group=None) -> bool:
    """Debug check that every rank holds the same values as the group's
    first rank (`misc.check_ddp_consistency`). Returns True when they do;
    raises AssertionError on every rank, naming the first tensor that
    differs on any rank. Every rank must pass the same names in one order."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for name, t in named:
        ref = t.detach().contiguous().clone()
        dist.broadcast(ref, src=src, group=group)
        differs = torch.ne(ref, t.detach()).any().to(torch.float32).reshape(1)
        dist.all_reduce(differs, group=group)
        if differs.item() > 0:
            raise AssertionError(f"replica divergence at {name}")
    return True


def reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Element-wise max of x over the group's ranks, without a gradient."""
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out

