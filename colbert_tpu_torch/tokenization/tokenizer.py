"""ColBERT tokenizer on a pure-Python BERT WordPiece tokenizer.

The JAX package tokenizes with ``transformers.BertTokenizerFast``
(``colbert_tpu/tokenization/tokenizer.py:48-139``); the port does not depend
on ``transformers`` and reproduces that tokenizer as the JAX package uses it:

* special tokens (``[PAD] [UNK] [CLS] [SEP] [MASK]`` and the ``[unusedN]``
  markers) are matched whole in the raw text, leftmost-longest;
* the text between them is normalised like the ``tokenizers`` BERT
  normaliser: drop NUL, U+FFFD and control characters, map whitespace to a
  space, surround CJK ideographs with spaces, then (when lower-casing) strip
  accents (NFD, drop ``Mn``) and lower-case character by character;
* pre-tokenisation splits on whitespace and isolates punctuation
  (ASCII punctuation or any Unicode ``P*`` category);
* WordPiece: greedy longest match, ``##`` continuation pieces, ``[UNK]`` for
  a word with an unmatched piece or more than 100 characters.

:class:`ColbertTokenizer` then builds the multiview and the marked
(punctuation-masked) batches exactly as the JAX class does.
"""

from __future__ import annotations

import functools
import os
import re
import unicodedata
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from colbert_tpu_torch.config import MultiviewConfig, TokenizerConfig
from colbert_tpu_torch.tokenization.punctuation import IGNORED_TOKENS

# Unicode White_Space (what Rust's char::is_whitespace tests)
_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200B))
)
_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
    (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)
_KEEP, _DROP, _SPACE, _CJK = 0, 1, 2, 3
_MAX_WORD_CHARS = 100
_BERT_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")

# ASCII fast path: controls removed, \t\n\r -> space
_ASCII_CLEAN = {c: None for c in range(32) if chr(c) not in "\t\n\r"}
_ASCII_CLEAN.update({127: None, 9: 32, 10: 32, 13: 32})


@functools.lru_cache(maxsize=1 << 16)
def _char_class(ch: str) -> int:
    """Clean-text and CJK class of one character: controls other than
    ``\\t\\n\\r`` are dropped before whitespace is mapped to a space."""
    cp = ord(ch)
    if ch in "\t\n\r":
        return _SPACE
    if cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C"):
        return _DROP
    if ch in _WHITESPACE:
        return _SPACE
    if any(lo <= cp <= hi for lo, hi in _CJK_RANGES):
        return _CJK
    return _KEEP


@functools.lru_cache(maxsize=1 << 16)
def _is_punct(ch: str) -> bool:
    """ASCII punctuation or a Unicode ``P*`` category."""
    if 33 <= ord(ch) <= 126 and not ch.isalnum():
        return True
    return unicodedata.category(ch).startswith("P")


class WordPieceTokenizer:
    """BERT WordPiece tokenizer over a ``vocab.txt`` (one token per line)."""

    def __init__(self, vocab_path: str, do_lower_case: bool = True,
                 special_tokens: Sequence[str] = ()):
        if os.path.isdir(vocab_path):
            vocab_path = os.path.join(vocab_path, "vocab.txt")
        self.vocab: Dict[str, int] = {}
        with open(vocab_path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        for tok in _BERT_SPECIALS:
            if tok not in self.vocab:
                raise ValueError(f"vocab {vocab_path} lacks the special token {tok}")
        self.lower = do_lower_case
        self.pad_id = self.vocab["[PAD]"]
        self.unk = "[UNK]"
        # special tokens missing from the vocab get ids after it, as
        # transformers' add_special_tokens assigns them
        self.added: Dict[str, int] = {}
        for tok in special_tokens:
            if tok not in self.vocab and tok not in self.added:
                self.added[tok] = len(self.vocab) + len(self.added)
        specials = set(_BERT_SPECIALS) | set(special_tokens)
        self._special_re = re.compile(
            "|".join(re.escape(t) for t in sorted(specials, key=len, reverse=True))
        )
        self._word_cache: Dict[str, Tuple[str, ...]] = {}

    def __len__(self) -> int:
        return len(self.vocab) + len(self.added)

    # ---- pipeline stages ----

    def normalize(self, text: str) -> str:
        if text.isascii():
            s = text.translate(_ASCII_CLEAN)
            return s.lower() if self.lower else s
        out: List[str] = []
        for ch in text:
            c = _char_class(ch)
            if c == _KEEP:
                out.append(ch)
            elif c == _SPACE:
                out.append(" ")
            elif c == _CJK:
                out.append(" " + ch + " ")
        s = "".join(out)
        if self.lower:
            s = unicodedata.normalize("NFD", s)
            # per character: Rust's to_lowercase has no final-sigma context
            s = "".join(ch.lower() for ch in s if unicodedata.category(ch) != "Mn")
        return s

    @staticmethod
    def pre_tokenize(s: str) -> List[str]:
        words: List[str] = []
        cur: List[str] = []
        for ch in s:
            if ch in _WHITESPACE:
                if cur:
                    words.append("".join(cur))
                    cur = []
            elif _is_punct(ch):
                if cur:
                    words.append("".join(cur))
                    cur = []
                words.append(ch)
            else:
                cur.append(ch)
        if cur:
            words.append("".join(cur))
        return words

    def wordpiece(self, word: str) -> Tuple[str, ...]:
        hit = self._word_cache.get(word)
        if hit is not None:
            return hit
        pieces: List[str] = []
        if len(word) > _MAX_WORD_CHARS:
            pieces = [self.unk]
        else:
            start, n = 0, len(word)
            while start < n:
                end = n
                cur = None
                while start < end:
                    sub = word[start:end] if start == 0 else "##" + word[start:end]
                    if sub in self.vocab:
                        cur = sub
                        break
                    end -= 1
                if cur is None:
                    pieces = [self.unk]
                    break
                pieces.append(cur)
                start = end
        out = tuple(pieces)
        if len(self._word_cache) < (1 << 18):
            self._word_cache[word] = out
        return out

    def _tokenize_plain(self, text: str, out: List[str]) -> None:
        for w in self.pre_tokenize(self.normalize(text)):
            out.extend(self.wordpiece(w))

    # ---- public API ----

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        pos = 0
        for m in self._special_re.finditer(text):
            if m.start() > pos:
                self._tokenize_plain(text[pos : m.start()], out)
            out.append(m.group())
            pos = m.end()
        if pos < len(text):
            self._tokenize_plain(text[pos:], out)
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab[self.unk]
        return [self.vocab.get(t, self.added.get(t, unk)) for t in tokens]

    def encode_batch(self, texts: Sequence[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """``padding="max_length", truncation=True, add_special_tokens=False``."""
        ids = np.full((len(texts), max_length), self.pad_id, np.int32)
        attn = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            row = self.convert_tokens_to_ids(self.tokenize(t)[:max_length])
            ids[i, : len(row)] = row
            attn[i, : len(row)] = 1
        return ids, attn


@dataclass
class TokenBatch:
    input_ids: np.ndarray        # (B, L) int32
    attention_mask: np.ndarray   # (B, L) int32
    active_mask: Optional[np.ndarray] = None  # (B, L') int32; L'=view_num for multiview

    def __iter__(self):
        yield self.input_ids
        yield self.attention_mask
        yield self.active_mask


class ColbertTokenizer:
    """Same API and outputs as ``colbert_tpu.tokenization.ColbertTokenizer``:
    queries, docs and the cross-encoder's (question, passage) pairs."""

    def __init__(self, cfg: TokenizerConfig, multiview: MultiviewConfig):
        if not cfg.vocab_path:
            raise ValueError("TokenizerConfig.vocab_path is required")
        self.cfg = cfg
        self.multiview = multiview
        if multiview.enabled:
            n = multiview.q_view + multiview.d_view
            markers = [f"[unused{i}]" for i in range(1, n + 1)]
            self.q_markers = "".join(markers[: multiview.q_view])
            self.d_markers = "".join(markers[multiview.q_view :])
        else:
            markers = ["[unused1]", "[unused2]"]
            self.q_markers = markers[0]
            self.d_markers = markers[1]
        self.tok = WordPieceTokenizer(cfg.vocab_path, cfg.do_lower_case, markers)

    @property
    def vocab_size(self) -> int:
        return len(self.tok)

    def encode_queries(self, texts: Sequence[str]) -> TokenBatch:
        if self.multiview.enabled:
            return self._encode_multiview(texts, self.cfg.query_maxlen, is_query=True)
        return self._encode_marked(texts, self.cfg.query_maxlen, is_query=True)

    def encode_docs(self, texts: Sequence[str]) -> TokenBatch:
        if self.multiview.enabled:
            return self._encode_multiview(texts, self.cfg.doc_maxlen, is_query=False)
        return self._encode_marked(texts, self.cfg.doc_maxlen, is_query=False)

    def encode_ce_pairs(self, pairs: Sequence[Tuple[str, str]]) -> TokenBatch:
        """``[CLS]q[SEP]p[SEP]`` cut at ``ce_maxlen`` tokens from the tail (a
        long passage loses its last ``[SEP]``, as the JAX output does) and
        padded to it; no active mask."""
        texts = [f"[CLS]{q}[SEP]{p}[SEP]" for q, p in pairs]
        return TokenBatch(*self.tok.encode_batch(texts, self.cfg.ce_maxlen))

    def _encode_marked(self, texts: Sequence[str], maxlen: int, is_query: bool) -> TokenBatch:
        """Non-multiview: ``[CLS]<marker>text[SEP]``, punctuation and [SEP] inactive."""
        marker = self.q_markers if is_query else self.d_markers
        b = len(texts)
        ids = np.zeros((b, maxlen), np.int32)
        attn = np.zeros((b, maxlen), np.int32)
        active = np.zeros((b, maxlen), np.int32)
        for i, t in enumerate(texts):
            toks = self.tok.tokenize(f"[CLS]{marker}{t}[SEP]")[:maxlen]
            L = len(toks)
            ids[i, :L] = self.tok.convert_tokens_to_ids(toks)
            attn[i, :L] = 1
            active[i, :L] = [0 if tk in IGNORED_TOKENS else 1 for tk in toks]
        return TokenBatch(ids, attn, active)

    def _encode_multiview(self, texts: Sequence[str], maxlen: int, is_query: bool) -> TokenBatch:
        marker = self.q_markers if is_query else self.d_markers
        view_num = self.multiview.q_view if is_query else self.multiview.d_view
        ids, attn = self.tok.encode_batch([f"{marker}{t}[SEP]" for t in texts], maxlen)
        active = np.ones((ids.shape[0], view_num), np.int32)
        return TokenBatch(ids, attn, active)
