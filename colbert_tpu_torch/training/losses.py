"""Training losses and in-batch ranking metrics: counterpart of
``colbert_tpu/training/losses.py:16-58``.  ``listnet_loss`` and ``kl_loss``
are the cross-encoder's distillation losses (``ce_trainer.py``).

Sorts are stable (``jnp.argsort`` is), so tied scores -- the -inf pad
columns of a partial eval batch among them -- rank by column index.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def biencoder_nll_loss(scores: torch.Tensor, positive_idx: torch.Tensor) -> torch.Tensor:
    """scores: (Q, D) similarity matrix (already temperature-scaled);
    positive_idx: (Q,) int -- column of the positive doc per query."""
    logprobs = F.log_softmax(scores, dim=1)
    return -logprobs.gather(1, positive_idx[:, None].long()).mean()


def listnet_loss(y_pred: torch.Tensor, y_true: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    p_true = F.softmax(y_true, dim=-1)
    p_pred = F.softmax(y_pred, dim=-1) + eps
    return torch.mean(-torch.sum(p_true * torch.log(p_pred), dim=-1))


def kl_loss(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """KL(softmax(y_true) || softmax(y_pred)) summed over every element and
    divided by the row count (not by the elements)."""
    logp = F.log_softmax(y_pred, dim=-1)
    q = F.softmax(y_true, dim=-1)
    logq = F.log_softmax(y_true, dim=-1)
    return torch.sum(q * (logq - logp)) / y_pred.shape[0]


def _positives_in_order(scores: torch.Tensor, group_size: int, num_pos: int) -> torch.Tensor:
    nq, _ = scores.shape
    order = torch.argsort(-scores, dim=-1, stable=True)  # descending
    col = torch.arange(nq, device=scores.device)[:, None] * group_size
    return (order >= col) & (order < col + num_pos)


def positive_ranks(scores: torch.Tensor, group_size: int, num_pos: int) -> torch.Tensor:
    """Per-query mean sorted rank of the positive docs (lower is better).
    Row i's positives are columns [i*group_size, i*group_size + num_pos)."""
    is_pos = _positives_in_order(scores, group_size, num_pos)
    ranks = torch.arange(scores.shape[1], device=scores.device).expand_as(is_pos)
    return torch.where(is_pos, ranks, 0).sum(dim=-1) / num_pos


def reciprocal_ranks(scores: torch.Tensor, group_size: int, num_pos: int) -> torch.Tensor:
    """Per-query reciprocal rank of the first positive."""
    is_pos = _positives_in_order(scores, group_size, num_pos)
    first = torch.argmax(is_pos.to(torch.int32), dim=-1)  # rank of the first positive
    return 1.0 / (first + 1.0)
