"""The collectives a sharded model runs, over one axis of a
:class:`~vsta_tpu_torch.parallel.mesh.Mesh`.

Under jit, JAX's partitioner inserts these itself: the gather of the
images over 'view' before the encoder, the psum of the warp's view sum,
the assembly of the features' cotangent over 'view' in its transpose,
the cross-shard sums of train-mode BatchNorm statistics, of the loss's
normalisers and of the gradients over 'data'. The port calls them by
hand, and only ``torch.distributed.all_reduce``, which NCCL and gloo both
take on CUDA tensors (gloo refuses CUDA tensors in ``all_gather``).

Two kinds of differentiable sum: over 'data' every rank computes its own
frames downstream, so the backward sums the cotangents
(:func:`all_reduce_sum`); over 'view' every rank of a data group computes
the same thing downstream, so each already holds the whole cotangent and
the backward passes it through (:func:`sum_to_replicated`).

``axis`` is ``"data"``, ``"view"`` or ``"mesh"`` (both). On an axis of one
rank every function returns its input and makes no collective, so a 1x1
mesh runs exactly the single-device code.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _axis(mesh, axis: str):
    """(process group, ranks on the axis, this rank's index on it)."""
    if axis == "data":
        return mesh.data_group, mesh.n_data, mesh.data_index
    if axis == "view":
        return mesh.view_group, mesh.n_view, mesh.view_index
    if axis == "mesh":
        return mesh.group, mesh.size, mesh.rank
    raise ValueError(f"unknown mesh axis {axis!r}: data, view or mesh")


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the axis; the backward sums the cotangents over the same
    axis (every rank's output depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, differentiable."""
    group, n, _ = _axis(mesh, axis)
    if n == 1:
        return x
    return _AllReduceSum.apply(x, group)


class _SumToReplicated(torch.autograd.Function):
    """Sum over the axis into a value every rank then uses alike; the
    backward passes the cotangent through (every rank holds the same)."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_to_replicated(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, differentiable, for a
    value that every rank of the axis then computes with alike (the
    warp's sum over the views, before the head that each view rank
    runs): its cotangent is the same on every rank, and the backward
    hands it to each rank's part as it is."""
    group, n, _ = _axis(mesh, axis)
    if n == 1:
        return x
    return _SumToReplicated.apply(x, group)


def sum_no_grad(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, outside autograd (the
    loss's normalisers, the reported losses, the gradients)."""
    group, n, _ = _axis(mesh, axis)
    if n == 1:
        return x
    return _sum(x.detach(), group)


def _gather_exact(x: torch.Tensor, group, n: int, index: int) -> torch.Tensor:
    """[n, *x.shape]: slot i holds rank i's ``x``, bit for bit.

    Each rank writes its ``x`` into its own slot of a zero buffer and the
    buffer is summed as bytes (uint8). Every byte of the sum is one rank's
    byte plus zeros, so no byte overflows and none carries into the next:
    the sum is the identity on each slot for any dtype and any value,
    -0.0, infinities and NaN payloads included. (A float sum of a
    zero-filled buffer would turn -0.0 into +0.0.)"""
    x = x.contiguous()
    buf = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[index] = x
    flat = buf.reshape(-1).view(torch.uint8)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return buf


class _Gather(torch.autograd.Function):
    """The exact gather along ``dim``; the backward sums the cotangents of
    every rank and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        ctx.group, ctx.index, ctx.dim, ctx.size = group, index, dim, x.shape[dim]
        parts = _gather_exact(x, group, n, index)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = _sum(g, ctx.group)
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None, None, None


def gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` on ``axis`` concatenated along ``dim`` in rank
    order, bit for bit, differentiable."""
    group, n, index = _axis(mesh, axis)
    if n == 1:
        return x
    return _Gather.apply(x, group, n, index, dim % x.ndim)


class _TakeSlice(torch.autograd.Function):
    """This rank's slice along ``dim`` of a value every rank holds whole;
    the backward gathers every rank's cotangent slice, exactly, so each
    rank holds the whole cotangent: the dual of :class:`_Gather`."""

    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        size = x.shape[dim] // n
        ctx.group, ctx.n, ctx.index, ctx.dim = group, n, index, dim
        return x.narrow(dim, index * size, size).clone()

    @staticmethod
    def backward(ctx, g):
        parts = _gather_exact(g, ctx.group, ctx.n, ctx.index)
        return torch.cat(list(parts.unbind(0)), dim=ctx.dim), None, None, None, None


def take_slice(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's part of ``x`` along ``dim`` (``x.shape[dim] / n``
    entries, in rank order), for an ``x`` that every rank of ``axis``
    holds alike. Differentiable: the backward assembles the ranks'
    cotangents, bit for bit, into the whole one on every rank, as JAX
    sums the zero-padded slices."""
    group, n, index = _axis(mesh, axis)
    if n == 1:
        return x
    dim %= x.ndim
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over {n} ranks of {axis!r}")
    return _TakeSlice.apply(x, group, n, index, dim)
