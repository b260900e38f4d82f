"""DuReader corpus reader: the port's copy of ``load_tsv_corpus`` from
``colbert_tpu/evaluation/dureader.py``."""

from __future__ import annotations

import csv
import sys
from pathlib import Path
from typing import List, Sequence


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
