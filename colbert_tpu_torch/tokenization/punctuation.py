"""Punctuation tables for the active-scoring mask: the port's copy of
``colbert_tpu/tokenization/punctuation.py``.

The reference masks out tokens that are CJK or ASCII punctuation (or
``[SEP]``) so they never participate in MaxSim
(``colbert/modeling/tokenizers.py:16-17,36``).  It sources the CJK set from
``zhon.hanzi.punctuation``; we inline the equivalent Unicode codepoints here
so the framework has no external data dependency.
"""

import string

# CJK punctuation, fullwidth ASCII variants, CJK brackets/dashes/quotes —
# the same codepoint set as zhon.hanzi.non_stops + zhon.hanzi.stops.
CJK_NON_STOPS = (
    # Fullwidth ASCII variants
    "＂＃＄％＆＇（）＊＋，－"
    "／：；＜＝＞＠［＼］＾＿"
    "｀｛｜｝～｟｠"
    # Halfwidth CJK punctuation
    "｢｣､"
    # CJK symbols and punctuation
    "　、〃"
    # CJK angle and corner brackets
    "〈〉《》「」『』【】"
    # CJK brackets and symbols/punctuation
    "〔〕〖〗〘〙〚〛〜〝〞〟"
    # Other CJK symbols
    "〰"
    # Special CJK indicators
    "〾〿"
    # Dashes
    "–—"
    # Quotation marks and apostrophe
    "‘’‛“”„‟"
    # General punctuation
    "…‧"
    # Overscores and underscores
    "﹏"
    # Small form variants
    "﹑﹔"
    # Latin punctuation
    "·"
)

CJK_STOPS = "！？｡。"

CJK_PUNCTUATION = CJK_NON_STOPS + CJK_STOPS

ASCII_PUNCTUATION = string.punctuation

#: Tokens excluded from MaxSim scoring (reference ``tokenizers.py:16-17``).
IGNORED_TOKENS = frozenset({"[SEP]"} | set(CJK_PUNCTUATION) | set(ASCII_PUNCTUATION))
