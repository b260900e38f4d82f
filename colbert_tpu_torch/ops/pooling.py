"""Pooling and span helpers: counterpart of ``colbert_tpu/ops/pooling.py``.

The reference's ``model_utils`` (``colbert/modeling/model_utils.py:5-43``):
``batch_index_select``, ``span_mean`` (span averages by prefix sums),
``max_pool_by_mask`` and ``avg_pool_by_mask``, with the JAX functions'
semantics.  Plain torch: the JAX package computes them outside Pallas too.
"""

from __future__ import annotations

import torch


def batch_index_select(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, L, ...), idx (B, K) -> (B, K, ...): a gather per row."""
    idx = idx.long().reshape(*idx.shape, *([1] * (t.ndim - 2))).expand(*idx.shape, *t.shape[2:])
    return torch.gather(t, 1, idx)


def span_mean(hidden: torch.Tensor, spans: torch.Tensor) -> torch.Tensor:
    """Token vectors averaged over word spans by prefix sums.

    hidden (B, L, H); spans (B, S, 2) int [start, end) -> (B, S, H).  An
    empty span (end <= start) gives zeros."""
    csum = torch.nn.functional.pad(torch.cumsum(hidden, dim=1), (0, 0, 1, 0))  # csum[:, i]: the first i summed
    start, end = spans[..., 0], spans[..., 1]
    tot = batch_index_select(csum, end) - batch_index_select(csum, start)
    n = torch.clamp(end - start, min=1)[..., None].to(hidden.dtype)
    return torch.where((end > start)[..., None], tot / n, torch.zeros((), dtype=hidden.dtype))


def max_pool_by_mask(t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """t (B, L, H), mask (B, L) -> (B, H): the max over unmasked positions
    (``finfo(dtype).min`` where a row has none)."""
    neg = torch.tensor(torch.finfo(t.dtype).min, dtype=t.dtype, device=t.device)
    return torch.where(mask[..., None] > 0, t, neg).amax(dim=1)


def avg_pool_by_mask(t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """t (B, L, H), mask (B, L) -> (B, H): the mean over unmasked positions
    (the count clamped at 1)."""
    m = mask[..., None].to(t.dtype)
    return (t * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
