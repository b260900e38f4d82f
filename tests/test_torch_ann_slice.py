"""The port's ANN slice (IVF build + sq probe + dedup + rerank) against the
JAX package, end to end on the CPU.

One corpus of 256 docs is encoded by the JAX package (fp32, hidden 32, two
layers, dim 256, multiview 4/16), and each package builds an sq index over
those parts.  The JAX searcher runs its TPU kernels in interpret mode
(``serve.rerank_kernel="pallas_interpret"``; the probe kernels interpret on
the CPU by default); ``max_candidates`` 128 keeps its fused-rerank gate
open and dim 256 with 16 rows per doc meets its int8 table's packing.  The
port gets the same weights (``models/convert.py``) and runs its plain
versions.  The JAX package's native host library is switched off (its
numpy fallbacks compute the same functions; the tracked library is built
for another CPU).

Limit: top-k scores within 1e-4 (the encoders agree to ~1e-6 and the
rerank sums run in another order); a pid may differ only where the scores
tie within that limit.
"""

import dataclasses
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from colbert_tpu.config import (
    ColbertConfig, IndexConfig, MeshConfig, ModelConfig, MultiviewConfig, ServeConfig, TokenizerConfig,
)
from colbert_tpu.indexing import CollectionEncoder as JaxEncoder
from colbert_tpu.indexing import IndexBuilder as JaxBuilder
from colbert_tpu.indexing import IndexStorage as JaxStorage
from colbert_tpu.models import ColbertModel as JaxModel
from colbert_tpu.ranking import ColbertSearcher as JaxSearcher
from colbert_tpu.tokenization import ColbertTokenizer as JaxTokenizer
from colbert_tpu_torch.config import ColbertConfig as PortConfig
from colbert_tpu_torch.indexing.builder import IndexBuilder
from colbert_tpu_torch.indexing.storage import IndexStorage
from colbert_tpu_torch.models.colbert import ColbertModel
from colbert_tpu_torch.models.convert import state_dict_from_jax_params
from colbert_tpu_torch.ranking.searcher import ColbertSearcher
from colbert_tpu_torch.tokenization import ColbertTokenizer
from colbert_tpu_torch.tokenization.vocab import build_vocab, write_vocab
from tests.test_end_to_end import TOPICS, corpus_texts

# The tests run in several workers at once beside JAX's own thread pools:
# two intra-op threads per worker keep the CPU from being oversubscribed.
torch.set_num_threads(2)

QUESTIONS = ["apple fruit", "piano music", "river water", "forest tree marble", "doc7 dragon",
             "", "silver wave", "doc100 apple"]
TOL = 1e-4


@pytest.fixture(scope="module")
def native_off():
    import colbert_tpu.native.lib as native

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_load", lambda: None)
        yield


@pytest.fixture(scope="module")
def ann_setup(tmp_path_factory, mesh8, native_off):
    import jax
    import jax.numpy as jnp

    tmp = tmp_path_factory.mktemp("ann")
    texts = corpus_texts(256)
    vp = write_vocab(build_vocab(texts + TOPICS, max_size=4000), tmp / "vocab.txt")
    cfg = ColbertConfig(
        model=ModelConfig(vocab_size=4096, hidden_size=32, num_layers=2, num_heads=2,
                          intermediate_size=64, max_position_embeddings=96, dim=256, dtype="float32"),
        multiview=MultiviewConfig(enabled=True, q_view=4, d_view=16),
        tokenizer=TokenizerConfig(vocab_path=str(vp), query_maxlen=16, doc_maxlen=48),
        index=IndexConfig(index_path=str(tmp / "jax_idx"), codec="sq", sq_dim=16, partitions=16,
                          kmeans_iters=5, num_parts=2),
        serve=ServeConfig(mode="ann", topk=5, nprobe=4, candidate_depth=32, max_candidates=128,
                          probe_list_topr=2, rerank_kernel="pallas_interpret"),
        mesh=MeshConfig(data=4, model=2),
    )
    jtok = JaxTokenizer(cfg.tokenizer, cfg.multiview)
    jmodel = JaxModel(cfg.model, cfg.multiview)
    ids = jnp.zeros((1, 16), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(11), ids, jnp.ones_like(ids),
                         jnp.zeros((1, 48), jnp.int32), jnp.ones((1, 48), jnp.int32))["params"]
    jstorage = JaxEncoder(cfg, jtok, params, mesh=mesh8).encode_corpus(texts, str(tmp / "jax_idx"), batch_size=32)
    shutil.copytree(tmp / "jax_idx" / "parts", tmp / "port_idx" / "parts")
    shutil.copy(tmp / "jax_idx" / "meta.json", tmp / "port_idx" / "meta.json")
    JaxBuilder(cfg, jstorage).build()
    pcfg = PortConfig.from_dict(cfg.to_dict())
    pcfg.index.index_path = str(tmp / "port_idx")
    IndexBuilder(pcfg, IndexStorage(tmp / "port_idx"), device="cpu").build()
    model = ColbertModel(pcfg.model, pcfg.multiview)
    model.load_state_dict(state_dict_from_jax_params(params, pcfg.model))
    tok = ColbertTokenizer(pcfg.tokenizer, pcfg.multiview)
    return cfg, pcfg, jtok, params, model, tok, texts, tmp


def _searchers(ann_setup, mesh8, index, rerank_dtype):
    cfg, pcfg, jtok, params, model, tok, _, tmp = ann_setup
    jcfg = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, rerank_dtype=rerank_dtype))
    js = JaxSearcher(jcfg, jtok, params, JaxStorage(tmp / index), mesh=mesh8)
    pc = PortConfig.from_dict(jcfg.to_dict())
    ps = ColbertSearcher(pc, tok, model, IndexStorage(tmp / index), device="cpu")
    return js, ps


def _assert_same_results(want, got, k):
    assert got.pids.shape == want.pids.shape == (len(QUESTIONS), k)
    fin = np.isfinite(want.scores)
    np.testing.assert_array_equal(np.isfinite(got.scores), fin)
    np.testing.assert_allclose(got.scores[fin], want.scores[fin], rtol=0, atol=TOL)
    tie = np.abs(got.scores - want.scores) <= TOL
    assert ((got.pids == want.pids) | tie).all()
    assert (got.pids[fin] >= 0).all()


@pytest.mark.parametrize("rerank_dtype", ["bfloat16", "int8"])
def test_searchers_agree_on_the_jax_index(ann_setup, mesh8, native_off, rerank_dtype):
    js, ps = _searchers(ann_setup, mesh8, "jax_idx", rerank_dtype)
    assert ps.emb_table.dtype == (torch.int8 if rerank_dtype == "int8" else torch.bfloat16)
    assert ps.rerank_cap == js.rerank_cap == 16
    want, got = js.search(QUESTIONS, topk=5), ps.search(QUESTIONS, topk=5)
    _assert_same_results(want, got, 5)
    # the ANN oracle: fp32 MaxSim over the served table
    _assert_same_results(js.search_brute_force(QUESTIONS, topk=5), ps.search_brute_force(QUESTIONS, topk=5), 5)


def test_jax_searcher_serves_the_port_index(ann_setup, mesh8, native_off):
    js, ps = _searchers(ann_setup, mesh8, "port_idx", "bfloat16")
    _assert_same_results(js.search(QUESTIONS, topk=5), ps.search(QUESTIONS, topk=5), 5)
    # nprobe and depth per request, as the socket protocol carries them
    _assert_same_results(js.search(QUESTIONS, topk=5, nprobe=2, depth=8),
                         ps.search(QUESTIONS, topk=5, nprobe=2, depth=8), 5)


def test_best_row_ranking_matches(ann_setup, mesh8, native_off):
    js, ps = _searchers(ann_setup, mesh8, "jax_idx", "bfloat16")
    js.cfg = dataclasses.replace(js.cfg, serve=dataclasses.replace(js.cfg.serve, candidate_ranking="best_row"))
    ps.cfg = PortConfig.from_dict(js.cfg.to_dict())
    _assert_same_results(js.search(QUESTIONS, topk=5), ps.search(QUESTIONS, topk=5), 5)


def test_searcher_refuses_unported_ann_modes(ann_setup, tmp_path):
    _, pcfg, _, _, model, tok, _, tmp = ann_setup
    storage = IndexStorage(tmp / "port_idx")
    for field, value in (("probe_impl", "token"), ("rerank_table", "host")):
        cfg = PortConfig.from_dict(pcfg.to_dict())
        setattr(cfg.serve, field, value)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ColbertSearcher(cfg, tok, model, storage, device="cpu")
    cfg = PortConfig.from_dict(pcfg.to_dict())
    cfg.serve.dedup_impl = "packed"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ColbertSearcher(cfg, tok, model, storage, device="cpu").search(["apple"])
    # a pq index, and a ragged corpus
    for name, edit in (("pq", lambda m: m.update(codec="pq")),
                       ("ragged", lambda m: m.update(multiview=False))):
        shutil.copytree(tmp / "port_idx", tmp_path / name)
        st = IndexStorage(tmp_path / name)
        meta = st.read_meta()
        edit(meta)
        st.write_meta(meta)
        if name == "ragged":
            (tmp_path / name / "parts" / "doclens.0.json").write_text("[1" + ", 16" * 127 + "]")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ColbertSearcher(PortConfig.from_dict(pcfg.to_dict()), tok, model, st, device="cpu")


def test_cli_encode_build_serve_evaluate(tmp_path, capsys):
    """encode -> build-index -> serve (ann) -> evaluate --remote through the
    port's CLI on the CPU, at a tiny size."""
    import json
    import socket

    from colbert_tpu_torch import cli
    from colbert_tpu_torch.config import (
        IndexConfig as PIndex, ModelConfig as PModel, MultiviewConfig as PMultiview,
        ServeConfig as PServe, TokenizerConfig as PTok,
    )
    from colbert_tpu_torch.models.convert import reference_state_dict
    from colbert_tpu_torch.serving.server import RetrievalClient

    docs = [f"第{i}篇 文档 topic{i % 5} words, more." for i in range(60)]
    corpus = tmp_path / "corpus.json"
    corpus.write_text(json.dumps(docs, ensure_ascii=False), encoding="utf-8")
    evals = tmp_path / "eval.json"
    evals.write_text(json.dumps([{"question": docs[i], "positive_ctxs": [docs[i]]} for i in (4, 9)],
                                ensure_ascii=False), encoding="utf-8")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = PortConfig(
        model=PModel(vocab_size=512, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                     max_position_embeddings=64, dim=64, dtype="float32"),
        multiview=PMultiview(enabled=True, q_view=4, d_view=4),
        tokenizer=PTok(vocab_path=write_vocab(build_vocab(docs), tmp_path / "vocab.txt"),
                       query_maxlen=16, doc_maxlen=32),
        index=PIndex(index_path=str(tmp_path / "index"), num_parts=2, codec="sq", sq_dim=16,
                     partitions=8, kmeans_iters=4),
        serve=PServe(mode="ann", topk=5, nprobe=4, candidate_depth=16, query_batch_size=4, port=port),
    )
    conf = tmp_path / "conf.yaml"
    cfg.to_yaml(conf)
    model = ColbertModel(cfg.model, cfg.multiview)
    model.init_weights(torch.Generator().manual_seed(0))
    weights = tmp_path / "pytorch.bin"
    torch.save(reference_state_dict(model.state_dict(), cfg.model), weights)
    common = ["--config", str(conf), "--pretrain", str(weights), "--device", "cpu"]

    cli.main(["encode", "--corpus", str(corpus), *common])
    cli.main(["build-index", *common])
    assert (tmp_path / "index" / "ivf" / "codes.npy").exists()
    errors = []

    def serve():
        try:
            cli.main(["serve", "--corpus", str(corpus), *common])
        except BaseException as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    client = RetrievalClient(cfg.serve.host, port, cfg.serve.authkey.encode())
    deadline = time.time() + 60
    while True:
        assert not errors, errors
        try:
            got = client.retrieve([docs[4], docs[9]], topk=5, depth=16, nprobe=4)
            break
        except ConnectionRefusedError:
            assert time.time() < deadline
            time.sleep(0.2)
    try:
        assert [len(r) for r in got] == [5, 5]
        assert all(t == docs[p] for row in got for p, _, t in row)
        # the socket answers what the in-process searcher computes
        local = ColbertSearcher(cfg, ColbertTokenizer(cfg.tokenizer, cfg.multiview), model,
                                IndexStorage(tmp_path / "index"), device="cpu")
        want = local.search([docs[4], docs[9]], topk=5, nprobe=4, depth=16)
        assert [[p for p, _, _ in row] for row in got] == want.pids.tolist()
        np.testing.assert_allclose([[s for _, s, _ in row] for row in got], want.scores, rtol=0, atol=1e-6)
        capsys.readouterr()
        cli.main(["evaluate", "--eval-data", str(evals), "--remote", "--topk", "5", *common])
        metrics = json.loads(capsys.readouterr().out)
        assert set(metrics) == {"mrr@10", "recall@50", "recall@100"}
    finally:
        client.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive() and not errors
