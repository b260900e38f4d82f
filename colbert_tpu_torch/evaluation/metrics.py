"""Retrieval evaluation metrics: the port's copy of ``colbert_tpu/evaluation/metrics.py``.

Exact-semantics port of the reference's ``eval_dureader``
(``proj_utils/dureader_utils.py:51-73``): MRR@10 by the rank of the FIRST
retrieved paragraph whose text is string-equal to any positive context, and
recall@k as whether any positive appears in the top-k.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np


def eval_retrieval(
    output_data: Sequence[Dict[str, Any]],
    topk: int = 10,
    recall_topk: Sequence[int] = (50, 100),
) -> Dict[str, float]:
    """Each element: {"res": [(pid, score, text), ...], "positive_ctxs": [str]}.

    Returns {"mrr@10": ..., "recall@50": ..., "recall@100": ...}.
    """
    max_recall = max(recall_topk)
    mrr = 0.0
    recall_hits = {k: [] for k in recall_topk}
    for t in output_data:
        pos = set(t["positive_ctxs"])
        res = t["res"]
        for i in range(min(topk, len(res))):
            if res[i][2] in pos:
                mrr += 1.0 / (i + 1)
                break
        true_index = max_recall
        for i in range(min(max_recall, len(res))):
            if res[i][2] in pos:
                true_index = i
                break
        for k in recall_topk:
            recall_hits[k].append(1.0 if true_index + 1 <= k else 0.0)
    n = max(1, len(output_data))
    out = {f"mrr@{topk}": mrr / n}
    for k in recall_topk:
        out[f"recall@{k}"] = float(np.mean(recall_hits[k])) if recall_hits[k] else 0.0
    return out


def mrr_at_k(ranked_ids: np.ndarray, positives: Sequence[set], k: int = 10) -> float:
    """id-based MRR@k: ranked_ids (B, >=k), positives[i] = set of relevant ids."""
    total = 0.0
    for i, pos in enumerate(positives):
        for j in range(min(k, ranked_ids.shape[1])):
            if int(ranked_ids[i, j]) in pos:
                total += 1.0 / (j + 1)
                break
    return total / max(1, len(positives))


def recall_at_k(ranked_ids: np.ndarray, positives: Sequence[set], k: int) -> float:
    hits = 0
    for i, pos in enumerate(positives):
        if pos & set(int(x) for x in ranked_ids[i, :k]):
            hits += 1
    return hits / max(1, len(positives))
