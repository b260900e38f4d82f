"""Top-k and the cross-shard merge: counterpart of ``colbert_tpu/ops/topk.py``.

The JAX merge all-gathers every shard's top-k along the last axis (shard
by shard) and takes ``jax.lax.top_k`` of that concatenation, which keeps
the lowest position among equal scores.  :func:`topk_merge_gathered` takes
the same concatenation and selects with ``ops/sq_probe.py::topk_first``,
the port's copy of that rule (-0.0 below +0.0), so the merged ids are
JAX's bit for bit.  Its inputs come from a concatenation over shards in one
process (``ranking/sharded.py``), or from :func:`all_gather_topk` across
ranks.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from colbert_tpu_torch.ops.sq_probe import topk_first


def topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lowest index (``jax.lax.top_k``).
    JAX's ``approx=True`` is the TPU's ``approx_max_k``; off the TPU both
    packages take the exact top-k."""
    lead = scores.shape[:-1]
    s, i = topk_first(scores.reshape(-1, scores.shape[-1]), k)
    return s.view(*lead, k), i.view(*lead, k)


def pad_shard_topk(scores: torch.Tensor, ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A shard's top-k ``(B, k_local)`` padded to ``k`` columns with -inf and
    id -1 (a shard with fewer than ``k`` docs, ``colbert_tpu/ranking/sharded.py:39-44``)."""
    short = k - scores.shape[-1]
    if short <= 0:
        return scores, ids
    pad = (*scores.shape[:-1], short)
    return (torch.cat([scores, scores.new_full(pad, float("-inf"))], dim=-1),
            torch.cat([ids, ids.new_full(pad, -1)], dim=-1))


def topk_merge_gathered(scores: Sequence[torch.Tensor], ids: Sequence[torch.Tensor], k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each shard's top-k ``(..., k_s)`` scores and GLOBAL ids, in shard
    order -> the global top ``min(k, sum k_s)``, ties to the earlier shard
    and column, as ``jax.lax.top_k`` over the shard-major concatenation."""
    all_s, all_i = torch.cat(list(scores), dim=-1), torch.cat(list(ids), dim=-1)
    s, pos = topk(all_s, min(k, all_s.shape[-1]))
    return s, all_i.gather(-1, pos)


def all_gather_topk(scores: torch.Tensor, ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Across ranks: every rank's top-k (same shape on each) gathered in rank
    order and merged by :func:`topk_merge_gathered`; every rank gets the result."""
    from colbert_tpu_torch.parallel.collectives import launched

    if not launched():
        return topk_merge_gathered([scores], [ids], k)
    import torch.distributed as dist

    n = dist.get_world_size()
    gs, gi = [torch.empty_like(scores) for _ in range(n)], [torch.empty_like(ids) for _ in range(n)]
    dist.all_gather(gs, scores.contiguous())
    dist.all_gather(gi, ids.contiguous())
    return topk_merge_gathered(gs, gi, k)
