"""Character-level vocab construction: the port's copy of ``build_vocab``
and ``write_vocab`` from ``colbert_tpu/tokenization/vocab.py``.

The reference assumes pretrained vocab files on disk; this synthesizes a
vocab from a corpus so the system runs end to end (tests, demos,
from-scratch training) without any pretrained artifact.
"""

from __future__ import annotations

import re
from collections import Counter
from pathlib import Path
from typing import Iterable, List

#: [unusedN] slots; multiview needs q_view + d_view of them (<=32 at defaults)
NUM_UNUSED = 64

SPECIALS = ["[PAD]"] + [f"[unused{i}]" for i in range(1, NUM_UNUSED + 1)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def build_vocab(texts: Iterable[str], min_count: int = 1, max_size: int = 30000) -> List[str]:
    """Character-level vocab (the natural unit for Chinese BERT) plus
    whole-word entries for alphanumeric words, mirroring WordPiece
    granularity: every char appears both bare and as a ``##`` continuation
    piece (the WordPiece fallback for unseen words), and the most frequent
    words become whole tokens."""
    chars: Counter = Counter()
    words: Counter = Counter()
    word_re = re.compile(r"[a-z0-9]+")
    for t in texts:
        tl = t.lower()
        for ch in tl:
            if ch.strip():
                chars[ch] += 1
        for w in word_re.findall(tl):
            words[w] += 1
    out = list(SPECIALS)
    seen = set(out)
    for ch, c in chars.most_common():
        if c >= min_count and ch not in seen:
            out.append(ch)
            seen.add(ch)
            out.append("##" + ch)
            seen.add("##" + ch)
    for w, c in words.most_common():
        if len(out) >= max_size:
            break
        if c >= min_count and len(w) > 1 and w not in seen:
            out.append(w)
            seen.add(w)
    return out[:max_size]


def write_vocab(vocab: List[str], path: str | Path) -> str:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf8") as f:
        for t in vocab:
            f.write(t + "\n")
    return str(path)
