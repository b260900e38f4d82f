"""The collectives of data-parallel training, over the process group that
``parallel/mesh.py::init_distributed`` joins (NCCL on the card, gloo on
CPU processes).  Without a process group every function is the identity
of one rank.

* :func:`gather_rows`: all ranks' rows, rank-major, differentiable.  Its
  backward sums the gradient over ranks (an all-reduce of the whole
  gradient, then this rank's slice): each rank's rows were scored by every
  rank's queries.  ``torch.distributed.nn.functional.all_gather`` takes
  another collective per backend for the same sum; this one is written
  out so that NCCL and gloo take the same path.
* :func:`average_grads`: the gradients summed over ranks and divided by the
  world size, once: with each rank's loss a mean over its own queries, the
  average is the gradient of the global batch's mean loss.
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
    buffer) and divide by the world size."""
    if not launched():
        return
    grads: List[torch.Tensor] = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]), grads)])


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of a scalar over ranks (the global batch's loss from each rank's mean)."""
    if not launched():
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y / dist.get_world_size()
