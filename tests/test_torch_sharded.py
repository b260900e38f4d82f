"""Corpus-sharded search of the port (``ranking/sharded.py``, ``ops/topk.py``)
against the JAX package, on the CPU.

* ``topk_merge_gathered``: against ``jax.lax.top_k`` over the same
  shard-major concatenation (forced ties, +-0.0, -inf, a short shard
  padded with -inf and id -1): ids and scores bit-equal;
* ``shard_index``: every array equal to JAX's ``shard_index``, over a
  uniform (multiview) and a ragged index, 4 and 3 shards;
* ``ShardedColbertSearcher`` with 4 shards on ``cpu`` (``make_mesh(devices=
  ["cpu"] * 4)``) against JAX's on its 4-way data mesh, from the same
  weights and parts: flat mode over bf16 and int8 tables, and the sq IVF
  index with a bf16 (K4) and an fp32 rerank table (``rerank_kernel``
  "pallas_interpret" and "xla" on the JAX side, as
  ``test_torch_ann_slice.py`` holds the unsharded searchers).  Scores
  within 1e-4 (the encoders agree to ~1e-6 and the sums run in another
  order), pids equal but where the scores tie within that limit;
* the sharded searchers against the port's unsharded ``ColbertSearcher``
  on the same index (as ``test_sharded_consistent_with_single``), and over
  a ragged index (bf16 stride buckets and the fp32 gather): flat equal
  within 1e-4; ANN probes each shard's lists (a superset of the unsharded
  candidates), so its k-th score is at least the unsharded searcher's,
  within 1e-4 (the JAX test holds them within 2e-2);
* a 4 x 2 mesh (``mesh.model=2``, tensor parallelism) against JAX's on
  ``mesh8`` and the port's 4 x 1;
* the refusals: pq4, the host table; the serving service over the sharded
  searcher.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from colbert_tpu.config import (
    ColbertConfig, IndexConfig, ModelConfig, MultiviewConfig, ServeConfig, TokenizerConfig,
)
from colbert_tpu.indexing import CollectionEncoder as JaxEncoder
from colbert_tpu.indexing import IndexBuilder as JaxBuilder
from colbert_tpu.indexing import IndexStorage as JaxStorage
from colbert_tpu.models import ColbertModel as JaxModel
from colbert_tpu.tokenization import ColbertTokenizer as JaxTokenizer
from colbert_tpu_torch.config import ColbertConfig as PortConfig
from colbert_tpu_torch.indexing.builder import IndexBuilder
from colbert_tpu_torch.indexing.storage import IndexStorage
from colbert_tpu_torch.models.colbert import ColbertModel
from colbert_tpu_torch.models.convert import state_dict_from_jax_params
from colbert_tpu_torch.ops.topk import all_gather_topk, pad_shard_topk, topk_merge_gathered
from colbert_tpu_torch.parallel.mesh import make_mesh
from colbert_tpu_torch.ranking.searcher import ColbertSearcher
from colbert_tpu_torch.ranking.sharded import ShardedColbertSearcher, shard_index
from colbert_tpu_torch.tokenization import ColbertTokenizer
from colbert_tpu_torch.tokenization.vocab import build_vocab, write_vocab
from tests.test_end_to_end import TOPICS, corpus_texts

torch.set_num_threads(2)

QUESTIONS = ["apple fruit", "piano music", "river water", "forest tree marble", "doc7 dragon", "",
             "silver wave", "doc100 apple"]
TOL = 1e-4
SHARDS = 4


@pytest.fixture(scope="module")
def native_off():
    import colbert_tpu.native.lib as native

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_load", lambda: None)
        yield


# ---- the merge ----

def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_merge_matches_jax_top_k(seed):
    rng = np.random.default_rng(seed)
    B, k = 6, 7
    scores, ids = [], []
    base = 0
    for s, n in enumerate((7, 7, 3, 7)):  # shard 2 holds 3 docs: its top-7 is padded
        v = rng.choice(np.array([0.5, 0.25, 0.0, -0.0, -1.0, np.inf, -np.inf], np.float32), size=(B, n))
        v[:, : n // 2] = np.sort(rng.normal(size=(B, n // 2)).astype(np.float32).round(1), axis=1)[:, ::-1]
        i = base + np.tile(np.arange(n, dtype=np.int32), (B, 1))
        ts, tp = pad_shard_topk(torch.from_numpy(v), torch.from_numpy(i), k)
        scores.append(ts)
        ids.append(tp)
        base += n
    got_s, got_i = topk_merge_gathered(scores, ids, k)
    all_s = np.concatenate([s.numpy() for s in scores], axis=1)
    all_i = np.concatenate([i.numpy() for i in ids], axis=1)
    want_s, pos = jax.lax.top_k(all_s, k)
    want_i = np.take_along_axis(all_i, np.asarray(pos), axis=1)
    np.testing.assert_array_equal(_bits(got_s.numpy()), _bits(want_s))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert (got_i.numpy()[np.isneginf(got_s.numpy())] == -1).any() or not np.isneginf(got_s.numpy()).any()
    s1, i1 = all_gather_topk(scores[0], ids[0], 3)  # no process group: the merge of one
    s2, i2 = topk_merge_gathered(scores[:1], ids[:1], 3)
    assert torch.equal(s1, s2) and torch.equal(i1, i2)


# ---- the index and the searchers ----

def _cfg(tmp, multiview=True, **serve):
    texts = corpus_texts(200)
    vp = write_vocab(build_vocab(texts + TOPICS, max_size=4000), tmp / "vocab.txt")
    cfg = ColbertConfig(
        model=ModelConfig(vocab_size=4096, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                          max_position_embeddings=96, dim=256, dtype="float32"),
        multiview=MultiviewConfig(enabled=multiview, q_view=4, d_view=16),
        tokenizer=TokenizerConfig(vocab_path=str(vp), query_maxlen=16, doc_maxlen=32 if multiview else 20),
        index=IndexConfig(index_path=str(tmp / "idx"), codec="sq", sq_dim=16, partitions=16, kmeans_iters=5,
                          num_parts=2),
        serve=ServeConfig(mode="ann", topk=5, nprobe=4, candidate_depth=32, max_candidates=128,
                          probe_list_topr=2, rerank_kernel="pallas_interpret", **serve),
    )
    return cfg, texts


@pytest.fixture(scope="module")
def sharded_setup(tmp_path_factory, mesh8, native_off):
    """200 docs encoded by the JAX package (multiview 4/16, dim 256), its sq index, the port model."""
    tmp = tmp_path_factory.mktemp("sharded")
    cfg, texts = _cfg(tmp)
    jtok = JaxTokenizer(cfg.tokenizer, cfg.multiview)
    ids = jax.numpy.zeros((1, 16), jax.numpy.int32)
    params = JaxModel(cfg.model, cfg.multiview).init(jax.random.PRNGKey(5), ids, ids + 1, ids, ids + 1)["params"]
    JaxEncoder(cfg, jtok, params, mesh=mesh8).encode_corpus(texts, str(tmp / "idx"), batch_size=40)
    JaxBuilder(cfg, JaxStorage(tmp / "idx")).build()
    pcfg = PortConfig.from_dict(cfg.to_dict())
    model = ColbertModel(pcfg.model, pcfg.multiview)
    model.load_state_dict(state_dict_from_jax_params(params, pcfg.model))
    return cfg, jtok, params, model, ColbertTokenizer(pcfg.tokenizer, pcfg.multiview), tmp


@pytest.fixture(scope="module")
def ragged_index(tmp_path_factory):
    """A ragged (multiview off) sq index built by the port over seeded random parts."""
    tmp = tmp_path_factory.mktemp("ragged")
    cfg, _ = _cfg(tmp, multiview=False)
    pcfg = PortConfig.from_dict(cfg.to_dict())
    rng = np.random.default_rng(3)
    storage = IndexStorage(tmp / "idx")
    n_docs = 0
    for part in range(2):
        doclens = rng.integers(1, 19, size=37).tolist()
        emb = rng.normal(size=(sum(doclens), 256)).astype(np.float32)
        storage.write_part(part, (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float16), doclens)
        n_docs += len(doclens)
    storage.write_meta({"dim": 256, "num_docs": n_docs, "num_embeddings": int(np.sum(storage.read_doclens())),
                        "multiview": False, "d_view": 16, "num_parts": 2, "embedding_dtype": "float16"})
    IndexBuilder(pcfg, storage, device="cpu").build()
    return cfg, tmp


@pytest.mark.parametrize("which, n_shards", [("uniform", 4), ("ragged", 3)])
def test_shard_index_equals_jax(sharded_setup, ragged_index, native_off, which, n_shards):
    from colbert_tpu.ranking.sharded import shard_index as jax_shard_index

    tmp = sharded_setup[-1] if which == "uniform" else ragged_index[1]
    want = jax_shard_index(JaxStorage(tmp / "idx"), n_shards)
    got = shard_index(IndexStorage(tmp / "idx"), n_shards)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["num_docs"].sum()) == len(IndexStorage(tmp / "idx").read_doclens())


def _serve(cfg, **kw):
    return dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, **kw))


def _port_sharded(cfg, model, tok, path):
    pcfg = PortConfig.from_dict(cfg.to_dict())
    return ShardedColbertSearcher(pcfg, tok, model, IndexStorage(path), mesh=make_mesh(devices=["cpu"] * SHARDS))


def _assert_attains(single, got):
    """Each rank's score of the sharded ANN result at least the unsharded searcher's."""
    assert got.scores.shape == single.scores.shape
    assert (got.scores >= single.scores - TOL).all()
    assert (got.pids >= 0).all() and (np.diff(got.scores, axis=1) <= 0).all()


def _assert_same_results(want, got, k, tol=TOL):
    assert got.pids.shape == want.pids.shape == (len(QUESTIONS), k)
    fin = np.isfinite(want.scores)
    np.testing.assert_array_equal(np.isfinite(got.scores), fin)
    np.testing.assert_allclose(got.scores[fin], want.scores[fin], rtol=0, atol=tol)
    tie = np.abs(got.scores - want.scores) <= tol
    assert ((got.pids == want.pids) | tie).all()
    assert (got.pids[fin] >= 0).all()


@pytest.mark.parametrize("mode, rerank_dtype, rerank_kernel", [
    ("flat", "bfloat16", None), ("flat", "int8", None),
    ("ann", "bfloat16", "pallas_interpret"), ("ann", "float32", "xla"),
])
def test_sharded_searchers_agree_with_jax(sharded_setup, mesh8, native_off, mode, rerank_dtype, rerank_kernel):
    from colbert_tpu.ranking.sharded import ShardedColbertSearcher as JaxSharded

    cfg, jtok, params, model, tok, tmp = sharded_setup
    cfg = _serve(cfg, mode=mode, rerank_dtype=rerank_dtype, rerank_kernel=rerank_kernel or cfg.serve.rerank_kernel)
    js = JaxSharded(cfg, jtok, params, JaxStorage(tmp / "idx"), mesh=mesh8)
    ps = _port_sharded(cfg, model, tok, tmp / "idx")
    assert ps.n_shards == js.n_shards == SHARDS
    got = ps.search(QUESTIONS, topk=5)
    _assert_same_results(js.search(QUESTIONS, topk=5), got, 5)
    single = ColbertSearcher(PortConfig.from_dict(cfg.to_dict()), tok, model, IndexStorage(tmp / "idx"), device="cpu")
    if mode == "flat":
        _assert_same_results(single.search(QUESTIONS, topk=5), got, 5)
    else:
        _assert_attains(single.search(QUESTIONS, topk=5), got)


@pytest.mark.parametrize("rerank_dtype", ["bfloat16", "float32"])
def test_sharded_ragged_agrees_with_single(sharded_setup, ragged_index, rerank_dtype):
    """A ragged corpus: stride buckets a shard (bf16, K4's plain version) or
    the fp32 gather, against the unsharded searcher."""
    model, tok = sharded_setup[3], sharded_setup[4]
    cfg, tmp = ragged_index
    pcfg = PortConfig.from_dict(_serve(cfg, rerank_dtype=rerank_dtype).to_dict())
    ps = ShardedColbertSearcher(pcfg, tok, model, IndexStorage(tmp / "idx"), mesh=make_mesh(devices=["cpu"] * 3))
    single = ColbertSearcher(pcfg, tok, model, IndexStorage(tmp / "idx"), device="cpu")
    assert not ps.uniform_doclen
    _assert_attains(single.search(QUESTIONS, topk=5), ps.search(QUESTIONS, topk=5))


@pytest.mark.parametrize("which", ["uniform", "ragged"])
def test_sharded_searchers_serve_48_query_rows(sharded_setup, ragged_index, mesh8, native_off, which):
    """48 query rows, more than one K4 launch takes: multiview at q_view 48
    (query_maxlen 56) against JAX's sharded searcher, and a ragged corpus's
    stride buckets with query_maxlen 48 against the unsharded searcher.  A
    score sums 48 views here, 4 in the other tests: against JAX it is held
    within 1e-4 per 16 views (the encoders agree to ~1e-6 of each view's
    score, ~0.6, and the sum of 48 rounds ~29.5 at an ulp of 1.9e-6)."""
    from colbert_tpu.ranking.sharded import ShardedColbertSearcher as JaxSharded

    cfg, jtok, params, model, _, tmp = sharded_setup
    if which == "uniform":
        cfg = dataclasses.replace(cfg, multiview=dataclasses.replace(cfg.multiview, q_view=48),
                                  tokenizer=dataclasses.replace(cfg.tokenizer, query_maxlen=56))
    else:
        cfg, tmp = ragged_index
        cfg = dataclasses.replace(cfg, tokenizer=dataclasses.replace(cfg.tokenizer, query_maxlen=48))
    pcfg = PortConfig.from_dict(cfg.to_dict())
    tok = ColbertTokenizer(pcfg.tokenizer, pcfg.multiview)
    state, model = model.state_dict(), ColbertModel(pcfg.model, pcfg.multiview)  # the same weights, 48 query rows
    model.load_state_dict(state)
    ps = _port_sharded(cfg, model, tok, tmp / "idx")
    got = ps.search(QUESTIONS, topk=5)
    assert tok.encode_queries(QUESTIONS).input_ids.shape == (len(QUESTIONS), cfg.tokenizer.query_maxlen)
    if which == "uniform":
        js = JaxSharded(cfg, JaxTokenizer(cfg.tokenizer, cfg.multiview), params, JaxStorage(tmp / "idx"), mesh=mesh8)
        _assert_same_results(js.search(QUESTIONS, topk=5), got, 5, tol=TOL * 48 / 16)
    else:
        assert not ps.uniform_doclen
        single = ColbertSearcher(pcfg, tok, model, IndexStorage(tmp / "idx"), device="cpu")
        _assert_attains(single.search(QUESTIONS, topk=5), got)


@pytest.mark.parametrize("change, error", [
    ({"index": {"codec": "pq4"}}, "single-chip only"),
    ({"serve": {"rerank_table": "host"}}, "single-device only"),
])
def test_sharded_refusals(sharded_setup, change, error):
    cfg, _, _, model, tok, tmp = sharded_setup
    if "index" in change:
        path = tmp / "pq4"
        shutil.copytree(tmp / "idx", path, dirs_exist_ok=True)
        meta = IndexStorage(path).read_meta()
        IndexStorage(path).write_meta({**meta, "codec": "pq4"})
    else:
        path = tmp / "idx"
        cfg = _serve(cfg, **change["serve"])
    with pytest.raises(ValueError, match=error):
        _port_sharded(cfg, model, tok, path)


def test_sharded_searcher_at_model_2(sharded_setup, mesh8, native_off):
    """A 4 x 2 mesh (``mesh.model=2``: each shard's queries encoded by a model
    group of two CPU positions) against JAX's sharded searcher on ``mesh8``
    (data 4 x model 2) and the port's 4 x 1 mesh, flat mode: the same
    results within ``TOL``."""
    import copy

    from colbert_tpu.ranking.sharded import ShardedColbertSearcher as JaxSharded

    cfg, jtok, params, model, tok, tmp = sharded_setup
    cfg = _serve(cfg, mode="flat")
    pcfg = PortConfig.from_dict(cfg.to_dict())
    tp = ShardedColbertSearcher(pcfg, tok, copy.deepcopy(model), IndexStorage(tmp / "idx"),
                                mesh=make_mesh(SHARDS, 2, devices=["cpu"] * (2 * SHARDS)))
    assert tp.n_shards == SHARDS and tp.model.model_group == (torch.device("cpu"),) * 2
    got = tp.search(QUESTIONS, topk=5)
    _assert_same_results(JaxSharded(cfg, jtok, params, JaxStorage(tmp / "idx"), mesh=mesh8).search(QUESTIONS, topk=5),
                         got, 5)
    _assert_same_results(_port_sharded(cfg, copy.deepcopy(model), tok, tmp / "idx").search(QUESTIONS, topk=5), got, 5)


def test_sharded_searcher_behind_the_service(sharded_setup):
    """``RetrievalService`` pipelines over the sharded searcher unchanged
    (``search_tokens_device``'s handle, ``close``): its triples are the
    searcher's pids and scores (the JAX test_sharded_device_path_and_service)."""
    from colbert_tpu_torch.serving.server import RetrievalService
    from tests.test_end_to_end import corpus_texts as texts_of

    cfg, _, _, model, tok, tmp = sharded_setup
    cfg = _serve(cfg, mode="flat", query_batch_size=3)
    ps = _port_sharded(cfg, model, tok, tmp / "idx")
    want = ps.search(QUESTIONS, topk=5)
    rows = RetrievalService(ps, texts_of(200), PortConfig.from_dict(cfg.to_dict())).retrieve(QUESTIONS, topk=5)
    assert [[p for p, _, _ in r] for r in rows] == [[int(p) for p in row if p >= 0] for row in want.pids]
    np.testing.assert_allclose([[s for _, s, _ in r] for r in rows], want.scores, rtol=0, atol=1e-6)
