"""Collectives that autograd differentiates, over a process group.

JAX's sharded paths get their collectives from ``shard_map`` and GSPMD,
which also transpose them for the backward pass.  Here each is an
``autograd.Function`` whose backward is written out:

* :func:`all_reduce_sum`: forward the sum over the group, backward the sum
  of the ranks' gradients (JAX's ``psum`` and its transpose).  The global
  BatchNorm statistics of a data-parallel step go through it: each rank's
  loss depends on every rank's rows through the global mean.
* :func:`copy_to_group` and :func:`reduce_from_group`: the two operators
  of Megatron's tensor parallelism.  ``copy_to_group`` is the identity
  forward and sums the gradient over the group; ``reduce_from_group`` sums
  the activations forward and passes the gradient through, since every
  rank of a model group computes the same loss from the same rows.
* :func:`broadcast` from one rank: the gradient stays with the source
  rank, because every rank holds the same cotangent downstream.
* :func:`send_to` and :func:`recv_from`: a pipeline stage's hand-off; the
  backward of a send receives the gradient from the next stage, the
  backward of a receive sends it to the previous one.  Messages carry a
  tag, so each gradient meets its activation.  Over gloo a CUDA tensor is
  staged through pinned host memory (gloo sends host memory only); NCCL
  and CPU tensors are sent as they are.

Ranks are global ranks of the default group where a peer is named;
``group`` is the group the collective runs over (``dist.group.WORLD`` or
a subgroup, as a :class:`..parallel.mesh.Mesh` holds it).  With
``group=None`` every function is the identity; a group of one
rank runs its collective, a copy, so a one-rank mesh computes the
single-process numbers bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


def world(group=None) -> int:
    """The size of ``group`` (None: 1, no group)."""
    return dist.get_world_size(group) if group is not None and dist.is_initialized() else 1


def _grouped(group) -> bool:
    """Whether collectives run: over any group, one rank's too (a one-rank
    collective is a copy, and the run shows its cost)."""
    return group is not None and dist.is_initialized()


def rank(group=None) -> int:
    """This process's rank in ``group`` (None: 0, no group)."""
    return dist.get_rank(group) if group is not None and dist.is_initialized() else 0


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, group):
        ctx.is_src = dist.get_rank() == src
        y = x.clone()
        dist.broadcast(y, src, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_src else torch.zeros_like(g)), None, None


def _staged(device: torch.device, group) -> bool:
    """Whether a message on ``device`` goes through host memory: gloo's
    send and receive move host memory only (given a CUDA tensor, its
    transport writes from the device address and the pair dies), while its
    collectives stage CUDA tensors themselves.  Decided by the group's
    backend, so NCCL and CPU messages go as they are."""
    return device.type == "cuda" and dist.get_backend(group) == dist.Backend.GLOO


def _send(x: torch.Tensor, dst: int, tag: int, group) -> None:
    x = x.contiguous()
    if _staged(x.device, group):
        # a blocking copy into pinned memory waits for this process's
        # stream only; gloo's send returns once the buffer is sent
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        x = host
    dist.send(x, dst, group=group, tag=tag)


def _recv(shape, dtype: torch.dtype, device: torch.device, src: int, tag: int,
          group) -> torch.Tensor:
    if not _staged(device, group):
        x = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(x, src, group=group, tag=tag)
        return x
    host = torch.empty(shape, dtype=dtype, pin_memory=True)
    dist.recv(host, src, group=group, tag=tag)
    return host.to(device)


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dst, tag, group):
        ctx.dst, ctx.tag, ctx.group = dst, tag, group
        ctx.shape, ctx.dtype = x.shape, x.dtype
        _send(x, dst, tag, group)
        # a zero that depends on x: added to the stage's output, it puts the
        # send in the graph, so its backward receives the gradient
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, zero_grad):
        g = _recv(ctx.shape, ctx.dtype, zero_grad.device, ctx.dst, ctx.tag, ctx.group)
        return g, None, None, None


class _Recv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, shape, dtype, src, tag, group):
        ctx.src, ctx.tag, ctx.group = src, tag, group
        return _recv(shape, dtype, anchor.device, src, tag, group)

    @staticmethod
    def backward(ctx, g):
        _send(g, ctx.src, ctx.tag, ctx.group)
        return None, None, None, None, None, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group; its backward sums the gradients."""
    return _AllReduceSum.apply(x, group) if _grouped(group) else x


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the group (JAX's ``pmean``): the sum, then a
    division by the group's size."""
    return all_reduce_sum(x, group) / world(group) if _grouped(group) else x


def copy_to_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the group."""
    return _CopyToGroup.apply(x, group) if _grouped(group) else x


def reduce_from_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the group forward; the gradient passes through."""
    return _ReduceFromGroup.apply(x, group) if _grouped(group) else x


def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank; the gradient stays with
    ``src``."""
    return _Broadcast.apply(x, src, group) if _grouped(group) else x


def send_to(x: torch.Tensor, dst: int, tag: int, group=None) -> torch.Tensor:
    """Send ``x`` to global rank ``dst``: -> a zero scalar to add to the
    stage's output, whose backward receives ``x``'s gradient from ``dst``."""
    return _Send.apply(x, dst, tag, group)


def recv_from(shape: Sequence[int], dtype: torch.dtype, src: int, tag: int, anchor: torch.Tensor,
              group=None) -> torch.Tensor:
    """A tensor received from global rank ``src``; its backward sends the
    gradient back.  ``anchor`` is a tensor on the device to receive on that
    the caller's backward reaches (the stage's own input): the result
    requires grad when it does, and the receive's backward runs whenever
    the anchor's graph is differentiated.  It gets no gradient."""
    return _Recv.apply(anchor, tuple(shape), dtype, src, tag, group)


def all_reduce_mean_flat(tensors: Sequence[torch.Tensor], group=None) -> list:
    """The group means of ``tensors`` through ONE collective: their
    elements in order in one flat float32 buffer, summed over the group,
    divided by its size and split back into views of their shapes."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if _grouped(group):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat = flat / torch.full((), float(world(group)), device=flat.device)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def group_ranks(group: Optional[object]) -> list:
    """The global ranks of ``group`` in its order ([0] for None)."""
    if group is None or not dist.is_initialized():
        return [0]
    return [dist.get_global_rank(group, i) for i in range(dist.get_world_size(group))]
