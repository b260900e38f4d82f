"""The rest of the port's ANN serving against the JAX package, on the CPU:
ragged (multiview off) corpora over stride buckets, the host-RAM rerank
table and the packed dedup.

One ragged corpus of 120 docs (1-12 topic repeats a doc, so the doclens
span several strides) is encoded by the JAX package (fp32, hidden 32, one
layer, dim 128, query_maxlen 16, doc_maxlen 48, multiview off), and each
package builds an sq and a pq4 index over those parts.  The JAX searcher
runs its TPU kernels in interpret mode (``serve.rerank_kernel=
"pallas_interpret"``: the stride-bucket rerank; ``"xla"`` for the fp32
table); the port gets the same weights (``models/convert.py``) and runs
its plain versions.  The JAX package's native host library is switched
off (its numpy fallbacks compute the same functions).

Limit: top-k scores within 1e-4 (the rerank sums run in another order);
a pid may differ only where the scores tie within that limit.  The bucket
helpers and the packed dedup are held bit for bit.
"""

import dataclasses
import shutil
import threading

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
from colbert_tpu.ops import rerank_pallas as jrp
from colbert_tpu.ranking import ColbertSearcher as JaxSearcher
from colbert_tpu.tokenization import ColbertTokenizer as JaxTokenizer
from colbert_tpu_torch.config import ColbertConfig as PortConfig
from colbert_tpu_torch.indexing.builder import IndexBuilder
from colbert_tpu_torch.indexing.storage import IndexStorage
from colbert_tpu_torch.models.colbert import ColbertModel
from colbert_tpu_torch.models.convert import state_dict_from_jax_params
from colbert_tpu_torch.ops import ivf as pivf, rerank as prr
from colbert_tpu_torch.ranking.searcher import BucketTables, ColbertSearcher, RaggedTable
from colbert_tpu_torch.tokenization import ColbertTokenizer
from colbert_tpu_torch.tokenization.vocab import build_vocab, write_vocab
from tests.test_end_to_end import TOPICS
from tests.test_ragged_rerank import ragged_corpus_texts
from tests.test_torch_ann_slice import _drive_cli

# The tests run in several workers at once beside JAX's own thread pools:
# two intra-op threads per worker keep the CPU from being oversubscribed.
torch.set_num_threads(2)

QUESTIONS = ["apple fruit", "piano music", "river water", "forest tree marble", "doc7 dragon", "",
             "silver wave", "doc100 apple"]
TOL = 1e-4


@pytest.fixture(scope="module")
def native_off():
    import colbert_tpu.native.lib as native

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_load", lambda: None)
        yield


@pytest.fixture(scope="module")
def ragged_setup(tmp_path_factory, mesh8, native_off):
    """The JAX-encoded ragged parts; ``{jax,port}_{sq,pq4}`` indexes over
    them, each built by its package."""
    import jax
    import jax.numpy as jnp

    tmp = tmp_path_factory.mktemp("ragged")
    texts = ragged_corpus_texts(120)
    vp = write_vocab(build_vocab(texts + TOPICS, max_size=4000), tmp / "vocab.txt")
    cfg = ColbertConfig(
        model=ModelConfig(vocab_size=4096, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                          max_position_embeddings=96, dim=128, dtype="float32"),
        multiview=MultiviewConfig(enabled=False),
        tokenizer=TokenizerConfig(vocab_path=str(vp), query_maxlen=16, doc_maxlen=48),
        index=IndexConfig(index_path=str(tmp / "jax_sq"), codec="sq", sq_dim=8, partitions=8, kmeans_iters=5,
                          num_parts=2, pq4_m=16, pq_kmeans_iters=4),
        serve=ServeConfig(mode="ann", topk=5, nprobe=8, candidate_depth=64, max_candidates=128,
                          rerank_kernel="pallas_interpret"),
        mesh=MeshConfig(data=4, model=2),
    )
    jtok = JaxTokenizer(cfg.tokenizer, cfg.multiview)
    jmodel = JaxModel(cfg.model, cfg.multiview)
    ids = jnp.zeros((1, 16), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(7), ids, jnp.ones_like(ids),
                         jnp.zeros((1, 48), jnp.int32), jnp.ones((1, 48), jnp.int32))["params"]
    JaxEncoder(cfg, jtok, params, mesh=mesh8).encode_corpus(texts, str(tmp / "jax_sq"), batch_size=8)
    pcfg = PortConfig.from_dict(cfg.to_dict())
    for codec in ("sq", "pq4"):
        for pkg in ("jax", "port"):
            name = tmp / f"{pkg}_{codec}"
            if name.name != "jax_sq":
                shutil.copytree(tmp / "jax_sq" / "parts", name / "parts")
                shutil.copy(tmp / "jax_sq" / "meta.json", name / "meta.json")
            if pkg == "jax":
                JaxBuilder(dataclasses.replace(cfg, index=dataclasses.replace(
                    cfg.index, index_path=str(name), codec=codec)), JaxStorage(name)).build(chunk=256)
            else:
                c = PortConfig.from_dict(pcfg.to_dict())
                c.index.index_path, c.index.codec = str(name), codec
                IndexBuilder(c, IndexStorage(name), device="cpu").build()
    model = ColbertModel(pcfg.model, pcfg.multiview)
    model.load_state_dict(state_dict_from_jax_params(params, pcfg.model))
    tok = ColbertTokenizer(pcfg.tokenizer, pcfg.multiview)
    doclens = np.asarray(JaxStorage(tmp / "jax_sq").read_doclens())
    assert len(set(doclens.tolist())) > 1, "the corpus must be ragged"
    return cfg, jtok, params, model, tok, tmp


def _searchers(ragged_setup, mesh8, index, query_maxlen=None, **serve_kw):
    """The JAX and the port searcher over ``index`` with ``serve_kw`` (and
    ``query_maxlen`` query rows, each package's tokenizer made anew)."""
    cfg, jtok, params, model, tok, tmp = ragged_setup
    jcfg = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, **serve_kw))
    if query_maxlen is not None:
        jcfg = dataclasses.replace(jcfg, tokenizer=dataclasses.replace(cfg.tokenizer, query_maxlen=query_maxlen))
        jtok = JaxTokenizer(jcfg.tokenizer, jcfg.multiview)
    pcfg = PortConfig.from_dict(jcfg.to_dict())
    if query_maxlen is not None:
        tok = ColbertTokenizer(pcfg.tokenizer, pcfg.multiview)
    js = JaxSearcher(jcfg, jtok, params, JaxStorage(tmp / index), mesh=mesh8)
    ps = ColbertSearcher(pcfg, tok, model, IndexStorage(tmp / index), device="cpu")
    return js, ps


def _assert_same_results(want, got, k=5):
    assert got.pids.shape == want.pids.shape == (len(QUESTIONS), k)
    fin = np.isfinite(want.scores)
    np.testing.assert_array_equal(np.isfinite(got.scores), fin)
    np.testing.assert_allclose(got.scores[fin], want.scores[fin], rtol=0, atol=TOL)
    tie = np.abs(got.scores - want.scores) <= TOL
    assert ((got.pids == want.pids) | tie).all()
    assert (got.pids[fin] >= 0).all()


# ---- the stride-bucket helpers, bit for bit ----

@pytest.mark.parametrize("row_multiple", [16, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stride_buckets_equal_jax(row_multiple, seed):
    rng = np.random.default_rng(seed)
    doclens = rng.integers(1, 200, size=int(rng.integers(1, 500)))
    for n_buckets in (4, 2, 7):
        want = jrp.stride_buckets(doclens, n_buckets=n_buckets, row_multiple=row_multiple)
        assert prr.stride_buckets(doclens, n_buckets=n_buckets, row_multiple=row_multiple) == want


@pytest.mark.parametrize("dtype", [np.float16, np.int8])
def test_build_ragged_buckets_equal_jax(dtype):
    rng = np.random.default_rng(3)
    doclens = rng.integers(1, 70, size=57)
    doclens[5] = 64  # exactly a stride
    emb = (rng.normal(size=(int(doclens.sum()), 24)) * 40).astype(dtype)
    strides = prr.stride_buckets(doclens, row_multiple=16)
    want, got = jrp.build_ragged_buckets(emb, doclens, strides), prr.build_ragged_buckets(emb, doclens, strides)
    assert len(got[0]) == len(want[0]) == len(strides)
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_build_ragged_buckets_refuses_an_overlong_doc():
    for build in (jrp.build_ragged_buckets, prr.build_ragged_buckets):
        with pytest.raises(ValueError, match="stride"):
            build(np.zeros((40, 4), np.float32), [40], [16])


# ---- the searcher over a ragged index ----

@pytest.mark.parametrize("index,rerank_dtype", [
    ("jax_sq", "bfloat16"), ("jax_sq", "int8"), ("jax_sq", "float32"), ("jax_pq4", "bfloat16"),
])
def test_searchers_agree_on_the_ragged_index(ragged_setup, mesh8, native_off, index, rerank_dtype):
    """bf16 and int8: stride buckets, the port's K4/K5 plain versions against
    JAX's interpreted kernels; float32: the port's ragged gather against
    JAX's XLA branch.  The recall oracles agree too.  At dim 128 JAX's row
    rule for int8 buckets (32 rows) leaves this corpus one bucket."""
    js, ps = _searchers(ragged_setup, mesh8, index, rerank_dtype=rerank_dtype,
                        rerank_kernel="xla" if rerank_dtype == "float32" else "pallas_interpret")
    if rerank_dtype == "float32":
        assert js.ragged_strides is ps.ragged_strides is None and isinstance(ps.emb_table, RaggedTable)
    else:
        assert isinstance(ps.emb_table, BucketTables) and ps.ragged_strides == js.ragged_strides
        assert len(ps.ragged_strides) == (2 if rerank_dtype == "bfloat16" else 1)
        assert {t.dtype for t in ps.emb_table.tables} == {getattr(torch, rerank_dtype)}
    assert not ps.uniform_doclen and ps.rerank_cap == js.rerank_cap
    _assert_same_results(js.search(QUESTIONS, topk=5), ps.search(QUESTIONS, topk=5))
    _assert_same_results(js.search_brute_force(QUESTIONS, topk=5), ps.search_brute_force(QUESTIONS, topk=5))


def test_jax_searcher_serves_the_port_ragged_index(ragged_setup, mesh8, native_off):
    js, ps = _searchers(ragged_setup, mesh8, "port_sq")
    # nprobe and depth per request, as the socket protocol carries them
    _assert_same_results(js.search(QUESTIONS, topk=5, nprobe=2, depth=8),
                         ps.search(QUESTIONS, topk=5, nprobe=2, depth=8))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_bucketed_rerank_scores_each_doc_over_its_own_rows(ragged_setup, dtype):
    """The bucketed entry (on the CPU: each bucket's plain version) equals
    its plain version and the MaxSim of each candidate over its own rows,
    with 0 joining the max where its bucket pads it: a zero row is the
    reference's masked row.  Strides of 16 rows, so int8 has buckets too."""
    st = IndexStorage(ragged_setup[-1] / "port_sq")
    emb, doclens = st.load_all_embeddings(), np.asarray(st.read_doclens())
    strides = prr.stride_buckets(doclens, row_multiple=16)
    assert len(strides) > 1
    inv = None
    if dtype == "int8":
        emb, scale = prr.quantize_emb_table(emb)
        inv = torch.from_numpy(1.0 / scale)
    raw, b_of, s_of = prr.build_ragged_buckets(emb, doclens, strides)
    t = BucketTables(tuple(torch.from_numpy(x).to(getattr(torch, dtype)) for x in raw), tuple(strides),
                     torch.from_numpy(b_of), torch.from_numpy(s_of))
    rng = np.random.default_rng(0)
    cand = torch.from_numpy(rng.integers(-1, len(doclens), size=(3, 50)).astype(np.int32))
    Qm = torch.from_numpy(rng.normal(size=(3, 16, 128)).astype(np.float32))
    got = prr.maxsim_rerank_buckets(cand, Qm, *t, inv_scale=inv)
    torch.testing.assert_close(got, prr.maxsim_rerank_buckets_ref(cand, Qm, *t, inv_scale=inv), rtol=0, atol=0)
    q = Qm * inv if inv is not None else Qm.to(torch.bfloat16).float()
    rows_of = torch.from_numpy(np.asarray(emb, np.float32))
    offs = np.concatenate([[0], np.cumsum(doclens)])
    for b, c in np.ndindex(3, 50):
        p = int(cand[b, c])
        if p < 0:
            assert got[b, c] == float("-inf")
            continue
        rows = rows_of[offs[p] : offs[p + 1]]
        best = (q[b] @ (rows if inv is not None else rows.to(torch.bfloat16).float()).T).amax(dim=1)
        if doclens[p] < strides[b_of[p]]:  # padded in its bucket: its zero rows join the max
            best = best.clamp_min(0.0)
        assert abs(float(got[b, c]) - float(best.sum())) <= TOL


def test_packed_dedup_serves_as_jax(ragged_setup, mesh8, native_off):
    """``serve.dedup_impl="packed"`` (with the fp32 table: the dedup is what
    differs)."""
    js, ps = _searchers(ragged_setup, mesh8, "jax_sq", dedup_impl="packed", rerank_dtype="float32",
                        rerank_kernel="xla")
    _assert_same_results(js.search(QUESTIONS, topk=5), ps.search(QUESTIONS, topk=5))


@pytest.mark.parametrize("serve_kw", [dict(rerank_dtype="bfloat16"), dict(rerank_dtype="int8"),
                                      dict(rerank_table="host")], ids=["bf16", "int8", "host"])
@pytest.mark.parametrize("query_rows", [33, 48])
def test_ragged_or_host_shapes_past_the_staged_route_are_refused(ragged_setup, mesh8, native_off, query_rows,
                                                                 serve_kw):
    """More query rows than one launch of K4/K5's route "staged" takes (32)
    are served, not refused: the stride buckets (bf16, int8) and the host
    table rerank the rows in chunks (``ops/rerank.py::sum_row_chunks``), and
    the top-5 equals the JAX searcher's, whose kernels take any count of rows."""
    js, ps = _searchers(ragged_setup, mesh8, "jax_sq", query_maxlen=query_rows, **serve_kw)
    assert ps.tok.cfg.query_maxlen == js.tok.cfg.query_maxlen == query_rows > prr.MAX_VIEWS
    assert (ps.host_table is not None) == (serve_kw.get("rerank_table") == "host")
    if ps.host_table is None:
        assert isinstance(ps.emb_table, BucketTables)
    enc = ps.tok.encode_queries(QUESTIONS)
    assert enc.input_ids.shape == (len(QUESTIONS), query_rows)
    _assert_same_results(js.search(QUESTIONS, topk=5), ps.search(QUESTIONS, topk=5))


# ---- the host-RAM rerank table ----

@pytest.mark.parametrize("funnel", [64, 2])
def test_host_table_matches_jax_on_the_ragged_index(ragged_setup, mesh8, native_off, funnel):
    """The funnel: the dedup's first ``host_rerank_candidates`` candidates
    (2 is widened to topk); the CSR host table with its doc offsets."""
    js, ps = _searchers(ragged_setup, mesh8, "jax_sq", rerank_table="host", host_rerank_candidates=funnel)
    assert ps.host_table.doc_offsets is not None and ps.host_table.rows.dtype == torch.int8
    assert ps.host_table.rows.shape[0] == js.host_table.shape[0]
    assert ps.host_funnel(5) == max(5, funnel)
    _assert_same_results(js.search(QUESTIONS, topk=5), ps.search(QUESTIONS, topk=5))
    if funnel == 64:
        # the oracle over the host table, dequantized
        _assert_same_results(js.search_brute_force(QUESTIONS, topk=5), ps.search_brute_force(QUESTIONS, topk=5))


def test_host_table_pipelines_batches_and_closes(ragged_setup, mesh8, native_off):
    """Two batches in flight through ``search_tokens_device`` (the second
    submitted before the first is read) equal the JAX host searcher's and
    the synchronous path's results; ``close()`` leaves no worker thread."""
    js, ps = _searchers(ragged_setup, mesh8, "jax_sq", rerank_table="host")
    batches = [QUESTIONS, QUESTIONS[::-1]]
    encs = [ps.tok.encode_queries(b) for b in batches]
    handles = [ps.search_tokens_device(e.input_ids, e.attention_mask, e.active_mask) for e in encs]
    assert any(t.name.startswith("host-rerank") for t in threading.enumerate())
    for b, e, h in zip(batches, encs, handles):
        ts, tp = h
        want = js.search(b, topk=5)
        np.testing.assert_allclose(ts, want.scores, rtol=0, atol=TOL)
        assert ((tp == want.pids) | (np.abs(ts - want.scores) <= TOL)).all()
        sync = ps.search_reps(ps.encode_queries(e.input_ids, e.attention_mask, e.active_mask),
                              torch.as_tensor(e.active_mask, dtype=torch.float32))
        np.testing.assert_array_equal(tp, sync[1].numpy())
        np.testing.assert_array_equal(ts, sync[0].numpy())
    ps.close()
    assert not any(t.name.startswith("host-rerank") for t in threading.enumerate())
    ps.close()  # a second close is a no-op


# ---- the packed dedup, bit for bit ----

@pytest.mark.parametrize("seed", range(6))
def test_packed_dedup_equals_jax(seed):
    """Seeded pids with -1 and repeats, scores with ties and -inf, rows all
    invalid or all tied: the same pids in the same order, the same scores."""
    import jax
    import jax.numpy as jnp

    from colbert_tpu.ops.ivf import dedup_pids_by_approx_maxsim_packed as jax_packed

    rng = np.random.default_rng(seed)
    B, qv, depth = 4, int(rng.integers(2, 9)), int(rng.integers(3, 40))
    n, num_docs = qv * depth, int(rng.integers(5, 400))
    max_out = int(rng.integers(1, n + 8))
    pids = rng.integers(-1, num_docs, size=(B, n)).astype(np.int32)
    scores = np.round(rng.normal(size=(B, n)), 2).astype(np.float32)  # rounding makes ties
    scores[rng.random((B, n)) < 0.1] = -np.inf
    scores[1] = 0.5
    pids[2] = -1
    tok = np.repeat(np.arange(qv, dtype=np.int32), depth)
    want_p, want_s = map(np.asarray, jax.jit(jax.vmap(
        lambda p, s: jax_packed(p, jnp.asarray(tok), s, qv, max_out, num_docs)))(jnp.asarray(pids), jnp.asarray(scores)))
    got_p, got_s = pivf.dedup_pids_by_approx_maxsim_packed(
        torch.from_numpy(pids), torch.from_numpy(tok), torch.from_numpy(scores), qv, max_out, num_docs)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_s.numpy().view(np.int32), want_s.view(np.int32))


def test_packed_dedup_refuses_a_key_too_wide():
    """(pid, token) over 25 bits leaves fewer than 6 score bits."""
    from colbert_tpu.ops.ivf import dedup_pids_by_approx_maxsim_packed as jax_packed

    pids, tok, scores = torch.zeros((1, 4), dtype=torch.int32), torch.zeros(4, dtype=torch.int32), torch.zeros((1, 4))
    for fn, args in ((pivf.dedup_pids_by_approx_maxsim_packed, (pids, tok, scores)),
                     (jax_packed, (pids[0].numpy(), tok.numpy(), scores[0].numpy()))):
        with pytest.raises(ValueError, match="too wide"):
            fn(*args, 32, 4, 1 << 21)


# ---- the CLI over a ragged corpus ----

@pytest.mark.parametrize("serve_kw", [
    {}, dict(rerank_dtype="int8"), dict(rerank_table="host", host_rerank_candidates=8), dict(dedup_impl="packed"),
], ids=["bf16", "int8", "host", "packed"])
def test_cli_serves_a_ragged_corpus(tmp_path, capsys, serve_kw):
    """encode (multiview off) -> build-index -> serve (ann) -> evaluate
    --remote; the socket's answers equal the in-process searcher's."""
    _drive_cli(tmp_path, capsys, dict(codec="sq", sq_dim=16), serve_kw, multiview=False)
