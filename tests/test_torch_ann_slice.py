"""The port's ANN slice (IVF build + probe + dedup + rerank) against the
JAX package, end to end on the CPU.

One corpus of 256 docs is encoded by the JAX package (fp32, hidden 32, two
layers, dim 256, multiview 4/16), and each package builds an sq, a pq4
and a pq index over those parts; the sq index is also served by the
token-major probe.  The JAX searcher runs its TPU kernels in interpret mode
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


def _searchers(ann_setup, mesh8, index, rerank_dtype, rerank_kernel=None):
    cfg, pcfg, jtok, params, model, tok, _, tmp = ann_setup
    jcfg = dataclasses.replace(cfg, serve=dataclasses.replace(
        cfg.serve, rerank_dtype=rerank_dtype, rerank_kernel=rerank_kernel or cfg.serve.rerank_kernel))
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


@pytest.mark.parametrize("rerank_dtype", ["bfloat16", "int8", "float32"])
def test_searchers_agree_on_the_jax_index(ann_setup, mesh8, native_off, rerank_dtype):
    """float32: the port's fp32 table and torch-op rerank against the JAX
    searcher's XLA branch (``serve.rerank_kernel="xla"``) over its fp32 table."""
    js, ps = _searchers(ann_setup, mesh8, "jax_idx", rerank_dtype,
                        rerank_kernel="xla" if rerank_dtype == "float32" else None)
    assert ps.emb_table.dtype == getattr(torch, rerank_dtype)
    assert ps.rerank_cap == js.rerank_cap == 16
    want, got = js.search(QUESTIONS, topk=5), ps.search(QUESTIONS, topk=5)
    _assert_same_results(want, got, 5)
    # the ANN oracle: fp32 MaxSim over the served table
    _assert_same_results(js.search_brute_force(QUESTIONS, topk=5), ps.search_brute_force(QUESTIONS, topk=5), 5)


@pytest.mark.parametrize("rerank_dtype", ["bfloat16", "int8"])
def test_searchers_agree_at_48_query_views(ann_setup, mesh8, native_off, rerank_dtype):
    """Multiview at q_view 48 (query_maxlen 56) over the same index: more
    query rows than one K4/K5 launch takes (16 on route "wgmma", 32 on
    "staged"), so the port reranks them in chunks of rows; its top-5 equals
    the JAX searcher's, whose kernels take any count of rows."""
    cfg, _, _, params, model, _, _, tmp = ann_setup
    jcfg = dataclasses.replace(
        cfg, multiview=dataclasses.replace(cfg.multiview, q_view=48),
        tokenizer=dataclasses.replace(cfg.tokenizer, query_maxlen=56),
        serve=dataclasses.replace(cfg.serve, rerank_dtype=rerank_dtype))
    pcfg = PortConfig.from_dict(jcfg.to_dict())
    js = JaxSearcher(jcfg, JaxTokenizer(jcfg.tokenizer, jcfg.multiview), params, JaxStorage(tmp / "jax_idx"),
                     mesh=mesh8)
    model48 = ColbertModel(pcfg.model, pcfg.multiview)  # the same weights, 48 query views
    model48.load_state_dict(model.state_dict())
    ps = ColbertSearcher(pcfg, ColbertTokenizer(pcfg.tokenizer, pcfg.multiview), model48,
                         IndexStorage(tmp / "jax_idx"), device="cpu")
    assert ps.emb_table.dtype == getattr(torch, rerank_dtype) and ps.rerank_cap == 16
    enc = ps.tok.encode_queries(QUESTIONS)
    assert ps.encode_queries(enc.input_ids, enc.attention_mask, enc.active_mask).shape == (len(QUESTIONS), 48, 256)
    _assert_same_results(js.search(QUESTIONS, topk=5), ps.search(QUESTIONS, topk=5), 5)


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


@pytest.fixture(scope="module")
def pq_indexes(ann_setup):
    """pq (m 64 x 8 bits) and pq4 (m 128 x 4 bits) indexes over the same
    parts, each built by both packages: ``{jax,port}_{pq,pq4}``."""
    cfg, pcfg, _, _, _, _, _, tmp = ann_setup
    for codec in ("pq", "pq4"):
        index = dict(codec=codec, pq_kmeans_iters=4)
        for pkg in ("jax", "port"):
            name = tmp / f"{pkg}_{codec}"
            shutil.copytree(tmp / "jax_idx" / "parts", name / "parts")
            shutil.copy(tmp / "jax_idx" / "meta.json", name / "meta.json")
            if pkg == "jax":
                JaxBuilder(dataclasses.replace(cfg, index=dataclasses.replace(
                    cfg.index, index_path=str(name), **index)), JaxStorage(name)).build()
            else:
                c = PortConfig.from_dict(pcfg.to_dict())
                c.index.index_path, c.index.codec, c.index.pq_kmeans_iters = str(name), codec, 4
                IndexBuilder(c, IndexStorage(name), device="cpu").build()
    return tmp


@pytest.mark.parametrize("index", ["jax_pq4", "port_pq4", "jax_pq", "port_pq"])
def test_searchers_agree_on_pq_indexes(ann_setup, pq_indexes, mesh8, native_off, index):
    """Each package serves the other's pq4 and pq index (the JAX searcher's
    K8 runs interpreted, its pq probe takes the CPU's gather ADC)."""
    js, ps = _searchers(ann_setup, mesh8, index, "bfloat16")
    assert ps.codec == js.codec == index.split("_")[1]
    _assert_same_results(js.search(QUESTIONS, topk=5), ps.search(QUESTIONS, topk=5), 5)


def test_token_probe_matches_the_jax_pallas_path(ann_setup, mesh8, native_off, monkeypatch):
    """``serve.probe_impl="token"`` on the sq index: the JAX searcher takes
    its Pallas path (K10 interpreted) only when ``COLBERT_TPU_SQ_PROBE`` is
    set as it traces, so its caches are cleared before and after."""
    import jax

    cfg = ann_setup[0]
    monkeypatch.setenv("COLBERT_TPU_SQ_PROBE", "pallas")
    jax.clear_caches()
    try:
        token = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, probe_impl="token"))
        js, ps = _searchers((token, *ann_setup[1:]), mesh8, "port_idx", "bfloat16")
        _assert_same_results(js.search(QUESTIONS, topk=5), ps.search(QUESTIONS, topk=5), 5)
    finally:
        monkeypatch.delenv("COLBERT_TPU_SQ_PROBE")
        jax.clear_caches()


def test_host_table_matches_jax_on_the_uniform_index(ann_setup, mesh8, native_off):
    """``serve.rerank_table="host"``: the int8 host table doc-major (16 rows
    a doc), the funnel's 64 best candidates gathered and reranked by K5's
    plain version against JAX's host searcher; the oracles over that table."""
    cfg = ann_setup[0]
    host = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, rerank_table="host",
                                                              host_rerank_candidates=64))
    js, ps = _searchers((host, *ann_setup[1:]), mesh8, "jax_idx", "bfloat16")
    assert ps.host_table.doc_offsets is None and tuple(ps.host_table.rows.shape) == js.host_table.shape
    assert ps.emb_table is None and ps.host_table.rows.dtype == torch.int8
    _assert_same_results(js.search(QUESTIONS, topk=5), ps.search(QUESTIONS, topk=5), 5)
    _assert_same_results(js.search_brute_force(QUESTIONS, topk=5), ps.search_brute_force(QUESTIONS, topk=5), 5)
    ps.close()


def _drive_cli(tmp_path, capsys, index_kw, serve_kw, multiview=True):
    """encode -> build-index -> serve (ann) -> evaluate --remote through the
    port's CLI on the CPU, at a tiny size (multiview 4/4, or off: ragged
    docs); the socket's answers must equal the in-process searcher's."""
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
        multiview=PMultiview(enabled=True, q_view=4, d_view=4) if multiview else PMultiview(enabled=False),
        tokenizer=PTok(vocab_path=write_vocab(build_vocab(docs), tmp_path / "vocab.txt"),
                       query_maxlen=16, doc_maxlen=32),
        index=PIndex(index_path=str(tmp_path / "index"), num_parts=2, partitions=8, kmeans_iters=4,
                     pq_kmeans_iters=4, **index_kw),
        serve=PServe(mode="ann", topk=5, nprobe=4, candidate_depth=16, query_batch_size=4, port=port,
                     **serve_kw),
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
        local.close()
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


def test_cli_encode_build_serve_evaluate(tmp_path, capsys):
    _drive_cli(tmp_path, capsys, dict(codec="sq", sq_dim=16), {})


@pytest.mark.parametrize("index_kw,serve_kw", [
    ({}, {}),                                    # the default IndexConfig: codec pq (pq_m 16 divides dim 64)
    (dict(codec="pq4", pq4_m=16), {}),           # pq4: m/2 = 8 bytes a row, a divisor of 128
    (dict(codec="sq", sq_dim=16), dict(probe_impl="token")),
], ids=["pq", "pq4", "sq-token"])
def test_cli_build_serve_each_codec(tmp_path, capsys, index_kw, serve_kw):
    _drive_cli(tmp_path, capsys, dict(pq_m=16, **index_kw), serve_kw)
