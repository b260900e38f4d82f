"""Hard-negative mining and the second-stage CLI chain of the port, on the CPU.

* the DuReader data generators (``colbert_tpu_torch/evaluation/dureader.py``)
  against the JAX package's originals: equal outputs on the same inputs;
* ``encode`` -> ``mine --distill-out`` -> ``train-ce`` (plain and distill)
  -> ``evaluate --rerank-ce`` through the port's CLI with ``--device cpu``
  at a tiny size: ``mine``'s files equal ``gen_iter_train_dev`` and
  ``gen_distill_data`` over the port service's own results, and the
  reranked metrics equal ``eval_retrieval`` over the service's results
  reordered by the CE checkpoint's own ``rerank``.
"""

import json

import numpy as np
import pytest
import torch

from colbert_tpu.evaluation import dureader as jd
from colbert_tpu_torch.evaluation import dureader as td

# two intra-op threads a worker: the suite runs in several workers beside JAX's thread pools
torch.set_num_threads(2)


def _retrieval_examples(seed=0, n=12, n_docs=30):
    """Examples with positives, old negatives (strings and DPR-style dicts)
    and retrieval triples that include some positives and old negatives."""
    rng = np.random.default_rng(seed)
    docs = [f"passage {i} " + "word " * int(rng.integers(1, 5)) for i in range(n_docs)]
    out = []
    for i in range(n):
        pos = [docs[int(p)] for p in rng.choice(n_docs, size=int(rng.integers(1, 3)), replace=False)]
        old = [docs[int(p)] for p in rng.choice(n_docs, size=int(rng.integers(0, 14)), replace=False)]
        if i % 3 == 1:
            pos = [{"text": t, "passage_id": 7} for t in pos]
            old = [{"text": t} for t in old]
        k = int(rng.integers(0, n_docs))
        pids = rng.permutation(n_docs)[:k]
        scores = np.sort(rng.normal(size=k))[::-1]
        ex = {"question": f"question {i}", "positive_ctxs": pos, "hard_negative_ctxs": old,
              "res": [(int(p), float(s), docs[int(p)]) for p, s in zip(pids, scores)]}
        if i % 4 == 0:
            del ex["hard_negative_ctxs"]
        out.append(ex)
    return out


GENERATORS = {
    "gen_ce_data": [{}, {"top": 5}],
    "gen_distill_data": [{}, {"group": 3}, {"group": 30}],
    "gen_iter_train_dev": [{}, {"keep_old": 2, "top": 6}, {"keep_old": 0}],
    "gen_dev_for_ce_test": [{}, {"top": 4}],
    "merge_to_reader_input": None,
    "make_submission": None,
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_equal_jax(name):
    exs = _retrieval_examples()
    if name == "merge_to_reader_input":
        results = [[(np.int64(p), np.float32(s), t) for p, s, t in ex["res"]] for ex in exs]
        base = [{k: v for k, v in ex.items() if k != "res"} for ex in exs]
        got, want = td.merge_to_reader_input(base, results), jd.merge_to_reader_input(base, results)
        assert got == want
        assert all(type(p) is int and type(s) is float for ex in got for p, s, _ in ex["res"])
        return
    if name == "make_submission":
        p2id = {str(p): f"id-{p}" for p in range(0, 30, 2)}
        for topk in (50, 3):
            assert td.make_submission(exs, p2id, topk=topk) == jd.make_submission(exs, p2id, topk=topk)
        return
    for kw in GENERATORS[name]:
        got, want = getattr(td, name)(exs, **kw), getattr(jd, name)(exs, **kw)
        assert got == want, kw
        assert json.dumps(got) == json.dumps(want)


def test_ctx_text_equal_jax():
    for c in ("plain", {"text": "dict", "passage_id": 3}):
        assert td._ctx_text(c) == jd._ctx_text(c)


def test_generator_inputs_exercise_each_branch():
    exs = _retrieval_examples()
    assert any("hard_negative_ctxs" not in e for e in exs)
    assert any(isinstance(e["positive_ctxs"][0], dict) for e in exs)
    assert 0 < len(td.gen_distill_data(exs, group=30)) < len(exs)  # some windows miss the positive
    pos_in_res = [any(r[2] in {td._ctx_text(c) for c in e["positive_ctxs"]} for r in e["res"]) for e in exs]
    assert any(pos_in_res)  # gen_ce_data has positives to remove
    mined = td.gen_iter_train_dev(exs, keep_old=2, top=6)
    old = [[td._ctx_text(c) for c in e.get("hard_negative_ctxs", [])[:2]] for e in exs]
    assert any(len(e.get("hard_negative_ctxs", [])) > 2 for e in exs)
    assert all(m["hard_negative_ctxs"][: len(o)] == o for m, o in zip(mined, old))


# ---- the CLI chain ----

def _chain_cfg(tmp_path, docs):
    import colbert_tpu_torch.config as tcfg
    from colbert_tpu_torch.tokenization import build_vocab, write_vocab

    vp = write_vocab(build_vocab(docs + ["question find"]), tmp_path / "vocab.txt")
    model = dict(vocab_size=512, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                 max_position_embeddings=64, dim=16, dtype="float32")
    return tcfg.ColbertConfig(
        model=tcfg.ModelConfig(**model),
        ce_model=tcfg.ModelConfig(**model),
        multiview=tcfg.MultiviewConfig(enabled=True, q_view=4, d_view=4),
        tokenizer=tcfg.TokenizerConfig(vocab_path=vp, query_maxlen=16, doc_maxlen=32, ce_maxlen=32),
        train=tcfg.TrainConfig(checkpoint_dir=str(tmp_path / "ckpt")),
        ce_train=tcfg.CETrainConfig(learning_rate=1e-3, per_device_batch_size=2, num_epochs=1, neg_num=2,
                                    neg_pool_lo=1, neg_pool_hi=5, eval_topk=5, distill_group=6, log_every=1,
                                    checkpoint_dir=str(tmp_path / "ce")),
        index=tcfg.IndexConfig(index_path=str(tmp_path / "index"), num_parts=2, pq_m=4),
        serve=tcfg.ServeConfig(mode="flat", topk=5, query_batch_size=4),
    )


def test_cli_encode_mine_train_ce_rerank(tmp_path, capsys):
    import argparse

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.evaluation import eval_retrieval
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.models.convert import reference_state_dict
    from colbert_tpu_torch.training import CETrainer

    rng = np.random.default_rng(0)
    topics = ["长江 河流", "北京 首都", "故宫 宫殿", "钢琴 音乐", "海洋 鱼类", "森林 树木"]
    docs = [f"{topics[i % 6]} 第{i}篇，" + "文字" * int(rng.integers(1, 4)) for i in range(24)]
    cfg = _chain_cfg(tmp_path, docs)
    conf = tmp_path / "conf.yaml"
    cfg.to_yaml(conf)
    model = ColbertModel(cfg.model, cfg.multiview)
    model.init_weights(torch.Generator().manual_seed(0))
    torch.save(reference_state_dict(model.state_dict(), cfg.model), tmp_path / "retriever.bin")
    corpus = tmp_path / "corpus.json"
    corpus.write_text(json.dumps(docs, ensure_ascii=False), encoding="utf-8")
    # a question equal to its passage: the random retriever finds it, so the
    # distillation windows hold their positive
    train = [{"question": docs[i], "positive_ctxs": [docs[i]],
              "hard_negative_ctxs": [docs[(i + j) % 24] for j in range(1, 5)]} for i in range(0, 24, 3)]
    (tmp_path / "train.json").write_text(json.dumps(train, ensure_ascii=False), encoding="utf-8")
    common = ["--config", str(conf), "--device", "cpu"]
    retr = ["--pretrain", str(tmp_path / "retriever.bin")]

    cli.main(["encode", "--corpus", str(corpus), *common, *retr])
    cli.main(["mine", "--corpus", str(corpus), "--eval-data", str(tmp_path / "train.json"), "--out",
              str(tmp_path / "mined.json"), "--topk", "6", "--keep-old", "2", "--distill-out",
              str(tmp_path / "distill.json"), *common, *retr])
    args = argparse.Namespace(checkpoint_step=None, pretrain=str(tmp_path / "retriever.bin"), device="cpu",
                              corpus=str(corpus))
    res = cli.make_service(cfg, args).retrieve([t["question"] for t in train], topk=6)
    merged = [{**t, "res": r} for t, r in zip(train, res)]
    mined = json.loads((tmp_path / "mined.json").read_text(encoding="utf-8"))
    distill = json.loads((tmp_path / "distill.json").read_text(encoding="utf-8"))
    assert mined == json.loads(json.dumps(td.gen_iter_train_dev(merged, keep_old=2, top=6)))
    assert distill == json.loads(json.dumps(td.gen_distill_data(merged, group=6)))
    assert all(m["hard_negative_ctxs"][:2] == t["hard_negative_ctxs"][:2] for m, t in zip(mined, train))
    assert len(distill) >= 2, len(distill)  # enough for a distillation step

    cli.main(["train-ce", "--train-data", str(tmp_path / "mined.json"), "--dev-data",
              str(tmp_path / "mined.json"), *common])
    ce_log = [json.loads(l) for l in (tmp_path / "ce" / "ce_train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in ce_log] == [2, 4]  # half-epoch cadence over 4 steps
    assert all(np.isfinite(r["loss"]) and 0 < r["dev_mrr"] <= 1 for r in ce_log)
    cli.main(["train-ce", "--train-data", str(tmp_path / "distill.json"), *common,
              "--set", "ce_train.distill_weight=0.5", "--set", f"ce_train.checkpoint_dir={tmp_path / 'ce_distill'}"])
    steps = [json.loads(l) for l in (tmp_path / "ce_distill" / "ce_train_steps.jsonl").read_text().splitlines()]
    assert len(steps) == len(distill) // 2 and all(np.isfinite(s["loss"]) for s in steps)

    evals = tmp_path / "eval.json"
    evals.write_text(json.dumps([{"question": d, "positive_ctxs": [d]} for d in docs[1:7]], ensure_ascii=False),
                     encoding="utf-8")
    capsys.readouterr()
    cli.main(["evaluate", "--eval-data", str(evals), "--corpus", str(corpus), "--topk", "4", "--rerank-ce",
              *common, *retr])
    got = json.loads(capsys.readouterr().out)
    ce = CETrainer(cfg, cli._tokenizer(cfg), device="cpu")
    params = ce.load_params_for_inference()
    assert ce.ckpt.latest_step() == 4
    data = json.loads(evals.read_text(encoding="utf-8"))
    rows = cli.make_service(cfg, args).retrieve([t["question"] for t in data], topk=5)
    want_rows = []
    for t, row in zip(data, rows):
        order = ce.rerank(t["question"], [x for _, _, x in row], params=params)
        assert sorted(order) == list(range(5))
        want_rows.append({**t, "res": [row[i] for i in order][:4]})
    assert got == json.loads(json.dumps(eval_retrieval(want_rows, topk=10, recall_topk=(50, 100))))
