"""DuReader corpus reader and hard-negative mining generators: the port's
copy of ``colbert_tpu/evaluation/dureader.py`` (capability parity with the
reference's ``proj_utils/dureader_utils.py``):

* :func:`load_tsv_corpus` — read TSV shards, passage text from a chosen
  column (reference reads 4 shards ``part-0{0..3}``, col 2, ``:17-27``);
* :func:`gen_ce_data` — CE training data: top-k retrieval results minus
  positives as hard negatives (``gen_ce``, ``:30-36``);
* :func:`gen_iter_train_dev` — iterative hard-negative mining: keep 10 old
  negatives + fresh top-50 retrievals not already present
  (``gen_iter_colbert_train_dev``, ``:76-83``);
* :func:`gen_dev_for_ce_test` — top-k candidates for CE rerank evaluation
  (``gen_dev_for_ce_test``, ``:39-48``).

All functions are pure (data in, data out) — no hardcoded paths.
``tests/test_torch_config.py`` and ``tests/test_torch_mine.py`` hold each
one equal to its original.
"""

from __future__ import annotations

import csv
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Sequence


def load_tsv_corpus(paths: Sequence[str | Path], text_col: int = 2, delimiter: str = "\t") -> List[str]:
    """Concatenate passage texts from TSV shards (order = shard order)."""
    csv.field_size_limit(sys.maxsize)
    out: List[str] = []
    for p in paths:
        with open(p, "r", encoding="utf8", newline="") as f:
            for row in csv.reader(f, delimiter=delimiter):
                if len(row) > text_col:
                    out.append(row[text_col])
    return out


def _ctx_text(c: Any) -> str:
    """Context -> text: training data stores contexts either as plain
    strings or as DPR-style ``{"text": ...}`` dicts (the trainer accepts
    both, so the mining generators must too)."""
    return c["text"] if isinstance(c, dict) else c


def gen_ce_data(examples: Iterable[Dict[str, Any]], top: int = 50) -> List[Dict[str, Any]]:
    """CE hard negatives: top-``top`` retrieval results minus positives.
    Each example carries ``res``: [(pid, score, text), ...]."""
    out = []
    for t in examples:
        pos = set(map(_ctx_text, t["positive_ctxs"]))
        negs = [r[2] for r in t["res"][:top] if r[2] not in pos]
        out.append(
            {
                "question": t["question"],
                "positive_ctxs": [_ctx_text(c) for c in t["positive_ctxs"]],
                "hard_negative_ctxs": negs,
            }
        )
    return out


def gen_distill_data(
    examples: Iterable[Dict[str, Any]], group: int = 8
) -> List[Dict[str, Any]]:
    """CE distillation data (ColBERTv2-style): per question, the retriever's
    top-``group`` window WITH its scores (``res_scored`` =
    [[teacher_score, text], ...]), positive moved to column 0 carrying its
    own teacher score.  Questions whose window contains no positive are
    dropped (the KL target needs an NLL anchor; the drop count is the
    caller's to report)."""
    out = []
    for t in examples:
        pos = set(map(_ctx_text, t["positive_ctxs"]))
        window = [(float(r[1]), r[2]) for r in t["res"][:group]]
        pos_idx = next((i for i, (_, x) in enumerate(window) if x in pos), None)
        if pos_idx is None:
            continue
        window.insert(0, window.pop(pos_idx))
        out.append(
            {
                "question": t["question"],
                "positive_ctxs": [window[0][1]],
                "res_scored": [[s, x] for s, x in window],
            }
        )
    return out


def gen_iter_train_dev(
    examples: Iterable[Dict[str, Any]], keep_old: int = 10, top: int = 50
) -> List[Dict[str, Any]]:
    """Iterative hard-negative refresh: ``keep_old`` previous negatives plus
    fresh top-``top`` retrievals not already kept."""
    out = []
    for t in examples:
        old = [_ctx_text(c) for c in t.get("hard_negative_ctxs", [])[:keep_old]]
        old_set = set(old)
        fresh = [r[2] for r in t["res"][:top] if r[2] not in old_set]
        out.append(
            {
                "question": t["question"],
                "positive_ctxs": [_ctx_text(c) for c in t["positive_ctxs"]],
                "hard_negative_ctxs": old + fresh,
            }
        )
    return out


def merge_to_reader_input(
    examples: Sequence[Dict[str, Any]], results: Sequence[Sequence[tuple]]
) -> List[Dict[str, Any]]:
    """Attach retrieval triples to examples as ``res`` (the packing the
    reference does in ``colbert_dataset.merge_to_reader_input``,
    ``colbert_dataset.py:37-48``)."""
    out = []
    for t, r in zip(examples, results):
        out.append({**t, "res": [(int(p), float(s), text) for p, s, text in r]})
    return out


def make_submission(
    eval_data: Sequence[Dict[str, Any]],
    passage2id: Dict[str, str],
    topk: int = 50,
) -> Dict[str, List[str]]:
    """DuReader leaderboard submission: question -> top-k passage ids via the
    ``passage2id.map.json`` map, which is keyed by the CORPUS INDEX as a
    string (``dense_server_client.py:100`` indexes it by ``str(pid)``).
    Each example carries ``res`` [(pid, score, text), ...]; the pid element
    of each triple is the corpus index used for the lookup."""
    sub: Dict[str, List[str]] = {}
    for t in eval_data:
        ids = []
        for pid, _, _ in t["res"][:topk]:
            mapped = passage2id.get(str(pid))
            if mapped is not None:
                ids.append(mapped)
        sub[t["question"]] = ids
    return sub


def gen_dev_for_ce_test(examples: Iterable[Dict[str, Any]], top: int = 300) -> List[Dict[str, Any]]:
    """Package retrieval results for CE rerank evaluation."""
    out = []
    for t in examples:
        out.append(
            {
                "question": t["question"],
                "positive_ctxs": list(t["positive_ctxs"]),
                "retrieval_res": [r[2] for r in t["res"][:top]],
            }
        )
    return out
