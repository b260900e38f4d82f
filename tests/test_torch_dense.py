"""The port's DPR path against the JAX package on the CPU: the pooling
helpers (``ops/pooling.py``), the flat index (``indexing/flat.py``) and the
dense retriever (``ranking/dense.py``).

Inputs come from numpy seeds; the retrievers share the JAX init, converted
(``models/convert.py``).  Tolerances: the pooling helpers within 1e-6 (fp32,
the same arithmetic in another order); flat scores within 1e-6 (fp32 inner
products of unit-scale vectors, summed in another order) and ids equal;
pooled vectors within 2e-5 (a tiny fp32 encoder on both sides, ~1e-6 apart,
then a mean and a norm).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.ops import pooling as jpool
from colbert_tpu_torch.ops import pooling as tpool
from tests.test_end_to_end import TOPICS, corpus_texts

torch.set_num_threads(2)


# ---- the pooling helpers ----

def _hidden(seed, B=3, L=11, H=8):
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 1, (B, L, H)).astype(np.float32)
    mask = (rng.random((B, L)) > 0.4).astype(np.int32)
    mask[0] = 0  # a row with nothing unmasked
    return h, mask


def test_batch_index_select_matches_jax():
    h, _ = _hidden(0)
    idx = np.random.default_rng(1).integers(0, h.shape[1], (h.shape[0], 5)).astype(np.int32)
    want = np.asarray(jpool.batch_index_select(jnp.asarray(h), jnp.asarray(idx)))
    got = tpool.batch_index_select(torch.from_numpy(h), torch.from_numpy(idx)).numpy()
    assert got.shape == want.shape == (3, 5, 8)
    np.testing.assert_array_equal(got, want)
    # an extra trailing axis, as ``t (B, L, ...)`` allows
    h4 = np.random.default_rng(2).normal(size=(2, 6, 3, 4)).astype(np.float32)
    idx4 = np.array([[5, 0], [2, 2]], np.int32)
    np.testing.assert_array_equal(tpool.batch_index_select(torch.from_numpy(h4), torch.from_numpy(idx4)).numpy(),
                                  np.asarray(jpool.batch_index_select(jnp.asarray(h4), jnp.asarray(idx4))))


def test_span_mean_matches_jax():
    h, _ = _hidden(3)
    rng = np.random.default_rng(4)
    start = rng.integers(0, h.shape[1] + 1, (h.shape[0], 6))
    end = rng.integers(0, h.shape[1] + 1, (h.shape[0], 6))
    spans = np.stack([start, end], axis=-1).astype(np.int32)
    spans[0, 0] = (4, 4)  # empty
    spans[0, 1] = (7, 2)  # reversed: empty
    spans[1, 0] = (0, h.shape[1])  # the whole row
    want = np.asarray(jpool.span_mean(jnp.asarray(h), jnp.asarray(spans)))
    got = tpool.span_mean(torch.from_numpy(h), torch.from_numpy(spans)).numpy()
    assert got.shape == want.shape == (3, 6, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not got[0, 0].any() and not got[0, 1].any()


@pytest.mark.parametrize("fn", ["max_pool_by_mask", "avg_pool_by_mask"])
def test_masked_pools_match_jax(fn):
    h, mask = _hidden(5)
    want = np.asarray(getattr(jpool, fn)(jnp.asarray(h), jnp.asarray(mask)))
    got = getattr(tpool, fn)(torch.from_numpy(h), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (3, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if fn == "max_pool_by_mask":  # the empty row: finfo.min, as JAX fills it
        assert (got[0] == np.finfo(np.float32).min).all()
    else:
        assert not got[0].any()


def test_pooling_is_exported_as_in_jax():
    import colbert_tpu.ops as jops
    import colbert_tpu_torch.ops as tops

    for name in ("batch_index_select", "span_mean", "max_pool_by_mask", "avg_pool_by_mask"):
        assert name in jops.__all__ and name in tops.__all__ and getattr(tops, name) is getattr(tpool, name)


# ---- the flat index ----

def _vectors(seed, n=300, d=16, b=7):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    q = rng.normal(size=(b, d)).astype(np.float32)
    return v, q


@pytest.mark.parametrize("topk", [10, 1000])
def test_flat_index_matches_jax(topk):
    """Scores within 1e-6 of JAX's, ids equal; k = min(topk, N)."""
    from colbert_tpu.indexing.flat import FlatIndex as JaxFlat
    from colbert_tpu_torch.indexing.flat import FlatIndex

    v, q = _vectors(6)
    ids = np.arange(1000, 1000 + len(v), dtype=np.int64)
    ws, wi = JaxFlat(v, ids).search(q, topk)
    gs, gi = FlatIndex(v, ids, device="cpu").search(q, topk)
    assert gs.shape == ws.shape == (7, min(topk, 300)) and gs.dtype == np.float32
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gi, wi)


def test_flat_index_ties_go_to_the_lowest_index():
    """Planted exact ties (duplicated rows) come out lowest index first, in
    both packages."""
    from colbert_tpu.indexing.flat import FlatIndex as JaxFlat
    from colbert_tpu_torch.indexing.flat import FlatIndex

    v, q = _vectors(7, n=50)
    v[[9, 23, 41]] = v[30]
    q[0] = v[30]
    gs, gi = FlatIndex(v, device="cpu").search(q, 5)
    ws, wi = JaxFlat(v).search(q, 5)
    assert list(gi[0, :4]) == [9, 23, 30, 41] and gs[0, 0] == gs[0, 3]
    np.testing.assert_array_equal(gi, wi)


def test_flat_index_files_load_in_both_directions(tmp_path):
    from colbert_tpu.indexing.flat import FlatIndex as JaxFlat
    from colbert_tpu_torch.indexing.flat import FlatIndex

    v, q = _vectors(8)
    ids = np.random.default_rng(9).permutation(len(v)).astype(np.int64)
    FlatIndex(v, ids, device="cpu").save(str(tmp_path / "port"))
    JaxFlat(v, ids).save(str(tmp_path / "jax"))
    for name in ("vectors.npy", "ids.npy"):
        a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    from_jax = FlatIndex.load(str(tmp_path / "jax"), device="cpu")
    from_port = JaxFlat.load(str(tmp_path / "port"))
    assert len(from_jax) == len(from_port) == len(v)
    (gs, gi), (ws, wi) = from_jax.search(q, 20), from_port.search(q, 20)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gi, wi)


def test_entry_points_default_to_the_card():
    import inspect

    from colbert_tpu_torch.indexing.flat import FlatIndex
    from colbert_tpu_torch.ranking.dense import DenseRetriever

    for fn in (FlatIndex.__init__, FlatIndex.load, DenseRetriever.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_top_level_api_exports_flat_index_and_builder():
    import colbert_tpu
    import colbert_tpu_torch
    from colbert_tpu_torch.indexing.builder import IndexBuilder
    from colbert_tpu_torch.indexing.flat import FlatIndex

    for name in ("FlatIndex", "IndexBuilder"):
        assert name in colbert_tpu.__all__ and name in colbert_tpu_torch.__all__
    assert colbert_tpu_torch.FlatIndex is FlatIndex and colbert_tpu_torch.IndexBuilder is IndexBuilder


# ---- the dense retriever ----

def _configs(tmp_path, multiview: bool, model: int = 1):
    from colbert_tpu.config import ColbertConfig as JaxConfig
    from colbert_tpu_torch.config import ColbertConfig
    from colbert_tpu_torch.tokenization.vocab import build_vocab, write_vocab

    texts = corpus_texts(40)
    vp = write_vocab(build_vocab(texts + TOPICS, max_size=4000), tmp_path / "vocab.txt")
    d = {"model": dict(vocab_size=4096, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                       max_position_embeddings=64, dim=16, dtype="float32"),
         "multiview": dict(enabled=multiview, q_view=4, d_view=8),
         "tokenizer": dict(vocab_path=str(vp), query_maxlen=12, doc_maxlen=24),
         "index": dict(pq_m=4), "mesh": dict(data=1, model=model)}
    return JaxConfig.from_dict(d), ColbertConfig.from_dict(d), texts


def _retrievers(tmp_path, multiview: bool, model: int = 1):
    from colbert_tpu.models import ColbertModel as FlaxColbert
    from colbert_tpu.parallel import make_mesh
    from colbert_tpu.ranking.dense import DenseRetriever as JaxDense
    from colbert_tpu.tokenization import ColbertTokenizer as JaxTokenizer
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.models.convert import state_dict_from_jax_params
    from colbert_tpu_torch.ranking.dense import DenseRetriever
    from colbert_tpu_torch.tokenization import ColbertTokenizer

    jcfg, cfg, texts = _configs(tmp_path, multiview, model)
    ids = jnp.zeros((1, 12), jnp.int32)
    params = FlaxColbert(jcfg.model, jcfg.multiview).init(
        jax.random.PRNGKey(4), ids, jnp.ones_like(ids), jnp.zeros((1, 24), jnp.int32),
        jnp.ones((1, 24), jnp.int32))["params"]
    rng = np.random.default_rng(12)  # non-trivial biases and LayerNorms
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
    jr = JaxDense(jcfg, JaxTokenizer(jcfg.tokenizer, jcfg.multiview), params,
                  mesh=make_mesh(1, model, devices=jax.devices()[:model]))
    model = ColbertModel(cfg.model, cfg.multiview)
    model.load_state_dict(state_dict_from_jax_params(params, cfg.model))
    tr = DenseRetriever(cfg, ColbertTokenizer(cfg.tokenizer, cfg.multiview), model, device="cpu")
    return jr, tr, texts


@pytest.mark.parametrize("multiview", [False, True])
def test_dense_retriever_matches_jax(tmp_path, multiview):
    """The same weights: pooled doc and query vectors within 2e-5 of JAX's
    (fp32, unit norm), the top-k ids equal, the scores within 2e-5; a
    passage's own vector scores 1.0 at the top; the save/load round trip
    between the two packages."""
    jr, tr, texts = _retrievers(tmp_path, multiview)
    questions = ["apple fruit", "ocean wave", "mountain snow", texts[3][:20], ""]
    for is_query, batch_texts in ((False, texts), (True, questions)):
        want = jr._encode(batch_texts, is_query=is_query, batch=16)
        got = tr._encode(batch_texts, is_query=is_query, batch=16)
        assert got.dtype == np.float32 and got.shape == want.shape == (len(batch_texts), 16)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    jr.build_index(texts, batch=16)
    tr.build_index(texts, batch=16)
    (ws, wi), (gs, gi) = jr.search(questions, topk=7), tr.search(questions, topk=7)
    assert gs.shape == ws.shape == (len(questions), 7)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=2e-5)
    gaps = np.diff(ws, axis=1)  # ids compared where no two scores are within the tolerance
    clear = np.concatenate([np.abs(gaps) > 4e-5, np.ones((len(questions), 1), bool)], axis=1) & \
        np.concatenate([np.ones((len(questions), 1), bool), np.abs(gaps) > 4e-5], axis=1)
    np.testing.assert_array_equal(gi[clear], wi[clear])
    own_s, own_i = tr.index.search(tr._encode([texts[3]], is_query=False), 3)
    assert own_s[0, 0] == pytest.approx(1.0, abs=1e-5) and own_i[0, 0] == 3
    tr.save_index(str(tmp_path / "port_flat"))
    jr.save_index(str(tmp_path / "jax_flat"))
    jr.load_index(str(tmp_path / "port_flat"))
    tr.load_index(str(tmp_path / "jax_flat"))
    (ws2, wi2), (gs2, gi2) = jr.search(questions, topk=7), tr.search(questions, topk=7)
    np.testing.assert_allclose(gs2, ws2, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(gi2[clear], wi2[clear])


def test_dense_retriever_at_model_2(tmp_path):
    """``mesh.model=2``: the port's retriever sharded over two CPU positions
    against its ``model = 1`` retriever (vectors within 1e-6, the same top-k)
    and JAX's at mesh data 1 x model 2 (vectors and scores within 2e-5, the
    top-k ids equal away from near ties)."""
    jr, tr, texts = _retrievers(tmp_path, True, model=2)
    assert tr.model.model_group == (torch.device("cpu"),) * 2
    _, one, _ = _retrievers(tmp_path, True)
    questions = ["apple fruit", "ocean wave", texts[3][:20]]
    for is_query, batch_texts in ((False, texts), (True, questions)):
        got = tr._encode(batch_texts, is_query=is_query, batch=16)
        np.testing.assert_allclose(got, one._encode(batch_texts, is_query=is_query, batch=16), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, jr._encode(batch_texts, is_query=is_query, batch=16), rtol=0, atol=2e-5)
    for r in (jr, tr, one):
        r.build_index(texts, batch=16)
    (ws, wi), (gs, gi), (os_, oi) = jr.search(questions, topk=7), tr.search(questions, topk=7), one.search(questions, 7)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(gi, oi)
    gaps = np.diff(ws, axis=1)
    clear = np.concatenate([np.abs(gaps) > 4e-5, np.ones((len(questions), 1), bool)], axis=1) & \
        np.concatenate([np.ones((len(questions), 1), bool), np.abs(gaps) > 4e-5], axis=1)
    np.testing.assert_array_equal(gi[clear], wi[clear])


def test_dense_retriever_refusals(tmp_path):
    """Search before an index is a RuntimeError, as in JAX; a tokenizer
    larger than the model is refused."""
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.ranking.dense import DenseRetriever
    from colbert_tpu_torch.tokenization import ColbertTokenizer

    _, cfg, _ = _configs(tmp_path, False)
    tok = ColbertTokenizer(cfg.tokenizer, cfg.multiview)
    r = DenseRetriever(cfg, tok, ColbertModel(cfg.model, cfg.multiview), device="cpu")
    with pytest.raises(RuntimeError, match="build_index"):
        r.search(["apple"])
    assert r._encode([], is_query=True).shape == (0, 16)
    small = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, vocab_size=50))
    with pytest.raises(ValueError, match="vocab"):
        DenseRetriever(small, tok, ColbertModel(small.model, cfg.multiview), device="cpu")
