"""Vocab construction: the port's copy of ``build_vocab`` (character-level),
``train_wordpiece`` (learned subword merges) and ``write_vocab`` from
``colbert_tpu/tokenization/vocab.py``.

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


def train_wordpiece(
    texts: Iterable[str],
    vocab_size: int = 30000,
    min_count: int = 2,
    max_merges: int | None = None,
) -> List[str]:
    """Learn a WordPiece vocabulary from a corpus (real subword merges).

    The reference assumes a PRETRAINED WordPiece vocab
    (``colbert/modeling/tokenizers.py:7-16``); when training from scratch the
    char+whole-word vocab of ``build_vocab`` fragments rare identifiers to characters.
    This trains merges with the WordPiece objective: repeatedly join the
    adjacent pair maximizing ``count(ab) / (count(a) * count(b))`` (the
    likelihood-gain rule used by BERT's original trainer and HF tokenizers),
    with ``##`` continuation pieces.

    CJK characters stay single tokens (the correct unit for Chinese BERT and
    what BertTokenizer's CJK splitter produces at encode time); merges are
    learned over alphanumeric words.
    """
    word_re = re.compile(r"[a-z0-9]+")
    words: Counter = Counter()
    chars: Counter = Counter()
    for t in texts:
        tl = t.lower()
        for ch in tl:
            # everything except ascii alnum (handled by merges) stays
            # char-level: punctuation, CJK, other scripts
            if ch.strip() and not ("a" <= ch <= "z" or "0" <= ch <= "9"):
                chars[ch] += 1
        for w in word_re.findall(tl):
            words[w] += 1

    # initial alphabet from the words themselves
    splits: dict = {}
    piece_count: Counter = Counter()
    for w, c in words.items():
        if c < min_count:
            continue
        pieces = [w[0]] + ["##" + ch for ch in w[1:]]
        splits[w] = pieces
        for p in pieces:
            piece_count[p] += c

    out = list(SPECIALS)
    seen = set(out)
    for ch, c in chars.most_common():
        if c >= min_count and ch not in seen:
            out.append(ch)
            seen.add(ch)
    for p in sorted(piece_count, key=lambda x: (-piece_count[x], x)):
        if p not in seen:
            out.append(p)
            seen.add(p)
    budget = vocab_size - len(out)
    if budget <= 0:
        return out[:vocab_size]
    if max_merges is not None:
        budget = min(budget, max_merges)

    # pair stats + inverted index word -> pairs
    pair_count: Counter = Counter()
    pair_words: dict = {}
    for w, pieces in splits.items():
        c = words[w]
        for a, b in zip(pieces, pieces[1:]):
            pair_count[(a, b)] += c
            pair_words.setdefault((a, b), set()).add(w)

    def merged_piece(a: str, b: str) -> str:
        return a + (b[2:] if b.startswith("##") else b)

    for _ in range(budget):
        best, best_score = None, 0.0
        for pair, pc in pair_count.items():
            if pc < min_count:
                continue
            denom = piece_count[pair[0]] * piece_count[pair[1]]
            score = pc / denom if denom else 0.0
            if score > best_score or (best is not None and score == best_score and pair < best):
                best, best_score = pair, score
        if best is None:
            break
        new_piece = merged_piece(*best)
        if new_piece in seen:  # already a token (e.g. single-char word)
            pair_count.pop(best, None)
            continue
        out.append(new_piece)
        seen.add(new_piece)
        # apply the merge only to words containing the pair
        for w in list(pair_words.get(best, ())):
            pieces = splits[w]
            c = words[w]
            # remove this word's old pair contributions
            for a, b in zip(pieces, pieces[1:]):
                pair_count[(a, b)] -= c
                s = pair_words.get((a, b))
                if s is not None:
                    s.discard(w)
            for p in pieces:
                piece_count[p] -= c
            i, np_ = 0, []
            while i < len(pieces):
                if i + 1 < len(pieces) and (pieces[i], pieces[i + 1]) == best:
                    np_.append(new_piece)
                    i += 2
                else:
                    np_.append(pieces[i])
                    i += 1
            splits[w] = np_
            for a, b in zip(np_, np_[1:]):
                pair_count[(a, b)] += c
                pair_words.setdefault((a, b), set()).add(w)
            for p in np_:
                piece_count[p] += c
    return out[:vocab_size]


def write_vocab(vocab: List[str], path: str | Path) -> str:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf8") as f:
        for t in vocab:
            f.write(t + "\n")
    return str(path)
