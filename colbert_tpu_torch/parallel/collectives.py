"""The collectives of the mesh's two axes.

The ``data`` axis: data-parallel training, over the process group that
``parallel/mesh.py::init_distributed`` joins (NCCL on the card, gloo on
CPU processes).  Without a process group each of these functions is the
identity of one rank.

* :func:`gather_rows`: all ranks' rows, rank-major, differentiable.  Its
  backward sums the gradient over ranks (an all-reduce of the whole
  gradient, then this rank's slice): each rank's rows were scored by every
  rank's queries.  ``torch.distributed.nn.functional.all_gather`` takes
  another collective per backend for the same sum; this one is written
  out so that NCCL and gloo take the same path.
* :func:`average_grads`: the gradients summed over ranks and divided by the
  world size, once: with each rank's loss a mean over its own queries, the
  average is the gradient of the global batch's mean loss.  A rank's
  gradients on several devices (its tensor-parallel shards) are reduced
  from one buffer on its first device.

The ``model`` axis: Megatron's two operators over one process's model
group (``models/sharding.py``), as autograd functions.  Their sums run in
position order on the first position's device, the same order every run:

* :func:`broadcast`: a copy of a tensor to each position; its backward
  sums the positions' gradients;
* :func:`reduce`: the sum of the positions' partial outputs; its backward
  copies the gradient back to each position.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist


def launched() -> bool:
    """Whether a process group is up (a launch with the three flags)."""
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """``(rank, world size)``; ``(0, 1)`` without a process group."""
    if not launched():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def barrier() -> None:
    if launched():
        dist.barrier()


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (same shape on each) concatenated along dim 0, rank-major."""
    if not launched():
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return all_gather_rows(x)

    @staticmethod
    def backward(ctx, grad):
        # reduced in the gradient's own layout (often a permuted one): the
        # reductions after it then sum in the order they would without the
        # gather, and one rank is bit-equal to no process group
        g = torch.empty_like(grad).copy_(grad)
        view = g.permute(sorted(range(g.dim()), key=lambda d: -g.stride(d)))
        if not view.is_contiguous():
            g = view = grad.contiguous()
        dist.all_reduce(view)
        r = dist.get_rank()
        return g[r * ctx.rows : (r + 1) * ctx.rows]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """:func:`all_gather_rows`, differentiable: the gradient of this rank's
    rows is the sum over ranks of the gradient of the gathered rows."""
    if not launched():
        return x
    return _GatherRows.apply(x)


def average_grads(params: Sequence[torch.nn.Parameter]) -> None:
    """Sum each parameter's ``.grad`` over ranks (one all-reduce of a flat
    buffer on the first gradient's device) and divide by the world size."""
    if not launched():
        return
    grads: List[torch.Tensor] = [p.grad for p in params if p.grad is not None]
    home = grads[0].device
    flat = torch.cat([g.reshape(-1).to(home) for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    parts = [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]), grads)]
    if all(g.device == home for g in grads):
        torch._foreach_copy_(grads, parts)
    else:
        for g, v in zip(grads, parts):
            g.copy_(v)


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of a scalar over ranks (the global batch's loss from each rank's mean)."""
    if not launched():
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y / dist.get_world_size()


# ---- the model axis ----

class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices):
        ctx.device, ctx.dtype = x.device, x.dtype
        return tuple(x.view_as(x) if d == x.device else x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        # summed in fp32 in position order, rounded once
        acc = None
        for g in grads:
            if g is None:
                continue
            g = g.to(ctx.device, torch.float32)
            acc = g.clone() if acc is None else acc.add_(g)
        return (None if acc is None else acc.to(ctx.dtype)), None


def broadcast(x: torch.Tensor, devices: Sequence[torch.device]) -> Tuple[torch.Tensor, ...]:
    """``x`` on each of ``devices`` (a view where it already lies there),
    differentiable: the gradient of ``x`` is the sum of the copies'
    gradients, in fp32 in position order on ``x``'s device."""
    return _Broadcast.apply(x, tuple(devices))


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *parts):
        ctx.places = [(p.device, p.dtype) for p in parts]
        home = parts[0].device
        acc = torch.empty(parts[0].shape, dtype=torch.float32, device=home).copy_(parts[0])
        for p in parts[1:]:
            acc.add_(p.to(home, torch.float32))
        return acc

    @staticmethod
    def backward(ctx, grad):
        return tuple(grad.to(d, t) for d, t in ctx.places)


def reduce(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The fp32 sum of ``parts`` (one a position, same shape), added in
    position order on the first one's device; differentiable: each part's
    gradient is the sum's, in the part's dtype on its device."""
    return _Reduce.apply(*parts)
