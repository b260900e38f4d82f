"""The port's pure-Python tokenizer against ``colbert_tpu.tokenization.ColbertTokenizer``
(``transformers.BertTokenizerFast``) on the same ``build_vocab`` vocab: ids,
attention and active masks must be identical, multiview and marked paths."""

import random

import numpy as np
import pytest

from colbert_tpu.config import MultiviewConfig, TokenizerConfig
from colbert_tpu.tokenization import ColbertTokenizer as HFTokenizer, build_vocab, write_vocab
from colbert_tpu_torch.tokenization import ColbertTokenizer

EDGE_CASES = [
    "中国的首都是北京。",
    "故宫，位于北京市中心！",
    "hello world, this is a test.",
    "长江是中国最长的河流？",
    "Café naïve résumé ΑΣ σ İstanbul",
    "x[SEP]y [sep] [CLS]z[unused3]w [unused40] [MASK][PAD][UNK]",
    "\t\n\x0b\x0c\r\x85\xa0　​  end",
    "ｈｅｌｌｏ　ＷＯＲＬＤ！（全角）《书名》【注】“引号”…—",
    "豈更 ﬁ ⅱ ①",
    "a" * 120 + " ok",
    "数字123abc xyz_def--ghi... $5+3=8 <a|b> ~`^",
    "\x00nul� rep ­ soft",
    "",
]
ALPHABET = (
    "abcdefghXYZ0123456789 ,.!?;:'\"()[]{}<>-_=+*&^%$#@~`|\\/"
    "中国北京长江河流首都是的。，！？、；：“”‘’（）《》【】…—éñüÖΣ\t\n"
)


def _texts():
    rng = random.Random(0)
    texts = list(EDGE_CASES)
    texts += ["".join(rng.choice(ALPHABET) for _ in range(rng.randint(0, 60))) for _ in range(300)]
    specials = ["[SEP]", "[unused1]", "[unused17]", "[unused32]", "[PAD]", "[unused]", "[CLS]"]
    texts += [
        "".join(rng.choice(ALPHABET) for _ in range(rng.randint(0, 6)))
        + rng.choice(specials)
        + "".join(rng.choice(ALPHABET) for _ in range(rng.randint(0, 6)))
        for _ in range(100)
    ]
    return texts


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    vocab = build_vocab(EDGE_CASES + list("abcdefghijklmnopqrstuvwxyz0123456789") + ["hello world test"])
    return write_vocab(vocab, tmp_path_factory.mktemp("vocab") / "vocab.txt")


@pytest.mark.parametrize("multiview", [True, False])
def test_tokenizer_matches_hf(vocab_path, multiview):
    cfg = TokenizerConfig(vocab_path=vocab_path, query_maxlen=32, doc_maxlen=48)
    mv = MultiviewConfig(enabled=multiview, q_view=16, d_view=16)
    ref, port = HFTokenizer(cfg, mv), ColbertTokenizer(cfg, mv)
    assert port.vocab_size == ref.vocab_size
    texts = _texts()
    for t in texts[:40]:
        assert port.tok.tokenize(t) == ref.tok.tokenize(t), repr(t)
    for fn in ("encode_queries", "encode_docs"):
        want, got = getattr(ref, fn)(texts), getattr(port, fn)(texts)
        for name in ("input_ids", "attention_mask", "active_mask"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype == np.int32 and a.shape == b.shape, (fn, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{fn}.{name}")


def test_tokenizer_requires_vocab():
    with pytest.raises(ValueError, match="vocab_path"):
        ColbertTokenizer(TokenizerConfig(vocab_path=""), MultiviewConfig())
