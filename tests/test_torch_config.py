"""The port's copies of the JAX package's framework-free modules against the originals.

``colbert_tpu_torch`` imports nothing of ``colbert_tpu``; it carries copies
of the config, vocab, punctuation, metrics and TSV-reader modules.  These
tests hold each copy to its original: the same dicts, the same errors, the
same outputs on the same inputs (exact equality throughout).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import colbert_tpu.config as jcfg
import colbert_tpu_torch.config as tcfg

REPO = Path(__file__).resolve().parent.parent


def test_default_config_equal():
    assert tcfg.ColbertConfig().to_dict() == jcfg.ColbertConfig().to_dict()
    for name in ("ModelConfig", "MultiviewConfig", "TokenizerConfig", "TrainConfig", "CETrainConfig",
                 "IndexConfig", "ServeConfig", "MeshConfig", "ColbertConfig"):
        t, j = getattr(tcfg, name), getattr(jcfg, name)
        assert [(f.name, str(f.type)) for f in dataclasses.fields(t)] == \
               [(f.name, str(f.type)) for f in dataclasses.fields(j)], name


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").glob("*.yaml")))
def test_repo_configs_equal(path):
    t = tcfg.load_config(REPO / path, {"train.learning_rate": "1e-4", "model.num_layers": 2})
    j = jcfg.load_config(REPO / path, {"train.learning_rate": "1e-4", "model.num_layers": 2})
    assert t.to_dict() == j.to_dict()
    assert t.to_json() == j.to_json()


def test_yaml_round_trip(tmp_path):
    """A YAML the port writes reads back the same in both packages."""
    tcfg.load_config(REPO / "configs" / "dureader.yaml").to_yaml(tmp_path / "c.yaml")
    assert jcfg.ColbertConfig.from_yaml(tmp_path / "c.yaml").to_dict() == \
           tcfg.ColbertConfig.from_yaml(tmp_path / "c.yaml").to_dict()


@pytest.mark.parametrize("overrides", [
    {"index.codec": "bogus"},
    {"model.dim": 100},                       # pq: dim % pq_m
    {"index.codec": "pq4", "index.pq4_m": 7},
    {"model.remat": "some"},
    {"model.dropout_impl": "fast"},
    {"model.attention_dropout_site": "ffn"},
    {"model.attention_softmax_dtype": "bf16"},
    {"model.embedding_impl": "gather"},
    {"serve.rerank_table": "disk"},
    {"serve.mode": "dense"},
    {"serve.flat_score_dtype": "fp16"},
    {"multiview.q_view": 64},
    {"bogus.key": 1},
    {"train.bogus": 1},
])
def test_same_errors(overrides):
    with pytest.raises(ValueError) as want:
        jcfg.load_config(None, overrides)
    with pytest.raises(ValueError) as got:
        tcfg.load_config(None, overrides)
    assert str(got.value) == str(want.value)


def test_unknown_yaml_key_same_error(tmp_path):
    (tmp_path / "c.yaml").write_text("model:\n  hidden: 3\n")
    with pytest.raises(ValueError) as want:
        jcfg.ColbertConfig.from_yaml(tmp_path / "c.yaml")
    with pytest.raises(ValueError) as got:
        tcfg.ColbertConfig.from_yaml(tmp_path / "c.yaml")
    assert str(got.value) == str(want.value)


def test_vocab_equal(tmp_path):
    from colbert_tpu.tokenization import vocab as jv
    from colbert_tpu_torch.tokenization import vocab as tv

    rng = np.random.default_rng(0)
    texts = ["".join(chr(c) for c in rng.integers(0x4E00, 0x4E00 + 400, size=30)) + f" word{i % 7} Mixed Case, punct!"
             for i in range(200)]
    assert tv.SPECIALS == jv.SPECIALS
    for kw in ({}, {"min_count": 3}, {"max_size": 150}):
        assert tv.build_vocab(texts, **kw) == jv.build_vocab(texts, **kw)
    v = tv.build_vocab(texts)
    assert Path(tv.write_vocab(v, tmp_path / "a.txt")).read_bytes() == \
           Path(jv.write_vocab(v, tmp_path / "b.txt")).read_bytes()


def test_punctuation_equal():
    from colbert_tpu.tokenization import punctuation as jp
    from colbert_tpu_torch.tokenization import punctuation as tp

    assert tp.IGNORED_TOKENS == jp.IGNORED_TOKENS
    assert tp.CJK_PUNCTUATION == jp.CJK_PUNCTUATION


def test_metrics_equal():
    from colbert_tpu.evaluation.metrics import eval_retrieval as j_eval, mrr_at_k as j_mrr, recall_at_k as j_rec
    from colbert_tpu_torch.evaluation.metrics import eval_retrieval as t_eval, mrr_at_k as t_mrr, recall_at_k as t_rec

    rng = np.random.default_rng(3)
    texts = [f"p{i}" for i in range(40)]
    data = [{"res": [(int(p), 1.0, texts[p]) for p in rng.permutation(40)[: int(rng.integers(0, 40))]],
             "positive_ctxs": list(rng.choice(texts, size=2))} for _ in range(25)]
    for kw in ({}, {"topk": 5, "recall_topk": (1, 3, 20)}):
        assert t_eval(data, **kw) == j_eval(data, **kw)
    ranked = rng.integers(0, 30, size=(10, 12))
    positives = [set(rng.integers(0, 30, size=3).tolist()) for _ in range(10)]
    assert t_mrr(ranked, positives, k=10) == j_mrr(ranked, positives, k=10)
    assert t_rec(ranked, positives, k=5) == j_rec(ranked, positives, k=5)


def test_tsv_corpus_equal(tmp_path):
    from colbert_tpu.evaluation import load_tsv_corpus as j_load
    from colbert_tpu_torch.evaluation import load_tsv_corpus as t_load

    a, b = tmp_path / "part-00", tmp_path / "part-01"
    a.write_text("1\tx\t第一段\n2\ty\t\"quoted\ttab\"\nshort\n", encoding="utf8")
    b.write_text("3\tz\tthird passage\n", encoding="utf8")
    assert t_load([a, b]) == j_load([a, b]) == ["第一段", "quoted\ttab", "third passage"]
    assert t_load([a], text_col=0) == j_load([a], text_col=0)


def test_version_equal():
    import colbert_tpu
    import colbert_tpu_torch

    assert colbert_tpu_torch.__version__ == colbert_tpu.__version__
