"""The port's collectives, as autograd functions on ``dist.all_reduce`` alone.

JAX needs none of these: XLA inserts its collectives from the shardings. The
port writes each one on a sum over an axis of the rank grid
(``core.mesh.Axis``): ``all_reduce`` runs under gloo on CPU and CUDA tensors
and under NCCL, so the same code runs across CPU processes, across processes
that share one card (where NCCL refuses a second rank) and across cards.
Gloo's point-to-point ops fail on CUDA tensors (they write from device
memory), and ``torch.distributed.nn``'s all-gather has a backward that falls
to ``all_to_all`` and sums the replicated gradients.

Gradients follow one convention. The loss of a step is the sum over the
``batch`` axis (data × spatial) of each rank's part, and the same on every
rank of a ``model`` line, whose ranks compute the same replicated values:

- :func:`sum_over`: forward all-reduce, backward all-reduce (each rank's part
  of the loss reads the sum).
- :func:`copy_to`: forward identity, backward all-reduce. At the input of an
  out-channel-sharded conv, each rank's input gradient is partial.
- :func:`gather_from`: forward writes the shard into its slot of a zero
  buffer and all-reduces it (adding zeros is exact, so this is an exact
  all-gather). Backward returns the rank's own slice: after a gather over
  ``model`` everything is replicated, so each rank already holds the whole
  gradient, and summing would multiply it by the axis size. With
  ``sum_grads=True`` (halo rows, which feed the neighbours' parts of the
  loss) backward all-reduces first.

An axis of one rank without a group makes each of them the identity; one of
more ranks without a group (a mesh laid out without a process group) raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduced(t, group):
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduced(g, ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduced(g, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index, dim, sum_grads):
        ctx.group, ctx.index, ctx.dim, ctx.sum_grads = group, index, dim, sum_grads
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * size
        buf = x.new_zeros(shape)
        buf.narrow(dim, index * n, n).copy_(x)
        dist.all_reduce(buf, group=group)
        ctx.n = n
        return buf

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            g = _all_reduced(g, ctx.group)
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None, None, None


def alone(axis) -> bool:
    """Whether ``axis``'s line is this rank alone, with nothing to reduce."""
    return axis.size == 1 and axis.group is None


def sum_over(x, axis):
    """The sum of ``x`` over the ranks of ``axis``'s line, on each of them."""
    if alone(axis):
        return x
    return _SumOver.apply(x, axis.group)


def copy_to(x, axis):
    """``x`` itself; its gradient summed over ``axis``'s line."""
    if alone(axis):
        return x
    return _CopyTo.apply(x, axis.group)


def gather_from(x, axis, dim, *, sum_grads=False):
    """The shards ``x`` of ``axis``'s ranks concatenated along ``dim`` in
    rank order (each rank's block at ``axis.index``), on each of them."""
    if alone(axis):
        return x
    return _GatherFrom.apply(x, axis.group, axis.size, axis.index, dim, sum_grads)


def reduce_sum(t, axis):
    """In-place sum of a tensor over ``axis``'s line, outside autograd (a
    loss to report, the gradients of a step). → ``t``."""
    if not alone(axis):
        dist.all_reduce(t, group=axis.group)
    return t
