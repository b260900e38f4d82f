"""The port's serving slice at a ColBERT dim that is not a multiple of 16,
against the JAX package, end to end on the CPU.

The TPU kernels take any dim (the flat scan K1/K2 and the bf16 rerank K4),
and so do the port's; the repo's operating point sets the dim equal to
BERT's hidden width (``configs/dureader.yaml``), 312 at TinyBERT-4L-zh's
widths.  Here a model of hidden 40, dim 40 (fp32, two layers, multiview
4/16) encodes 128 docs with the JAX package; each package builds an sq
index (sq_dim 8) over those parts.  The JAX searcher runs its TPU
kernels in interpret mode (``serve.rerank_kernel="pallas_interpret"``);
the port gets the same weights (``models/convert.py``) and runs its plain
versions.  The JAX package's native host library is switched off (its
numpy fallbacks compute the same functions; the tracked library is built
for another CPU).

Limit: top-k scores within 1e-4 (the encoders agree to ~1e-6 and the sums
run in another order); a pid may differ only where the scores tie within
that limit.
"""

import dataclasses
import shutil

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

DIM = 40
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
def odd_setup(tmp_path_factory, mesh8, native_off):
    import jax
    import jax.numpy as jnp

    tmp = tmp_path_factory.mktemp("odd_dim")
    texts = corpus_texts(128)
    vp = write_vocab(build_vocab(texts + TOPICS, max_size=4000), tmp / "vocab.txt")
    cfg = ColbertConfig(
        model=ModelConfig(vocab_size=4096, hidden_size=DIM, num_layers=2, num_heads=2,
                          intermediate_size=64, max_position_embeddings=96, dim=DIM, dtype="float32"),
        multiview=MultiviewConfig(enabled=True, q_view=4, d_view=16),
        tokenizer=TokenizerConfig(vocab_path=str(vp), query_maxlen=16, doc_maxlen=48),
        index=IndexConfig(index_path=str(tmp / "jax_idx"), codec="sq", sq_dim=8, partitions=16,
                          kmeans_iters=5, num_parts=2),
        serve=ServeConfig(mode="ann", topk=5, nprobe=4, candidate_depth=32, max_candidates=128,
                          probe_list_topr=2, rerank_kernel="pallas_interpret"),
        mesh=MeshConfig(data=4, model=2),
    )
    jtok = JaxTokenizer(cfg.tokenizer, cfg.multiview)
    jmodel = JaxModel(cfg.model, cfg.multiview)
    ids = jnp.zeros((1, 16), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(13), ids, jnp.ones_like(ids),
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
    return cfg, jtok, params, model, tok, tmp


def _configs(cfg, **serve):
    jcfg = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, **serve))
    return jcfg, PortConfig.from_dict(jcfg.to_dict())


def _searchers(odd_setup, mesh8, index, **serve):
    cfg, jtok, params, model, tok, tmp = odd_setup
    jcfg, pcfg = _configs(cfg, **serve)
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


@pytest.mark.parametrize("rerank_dtype", ["bfloat16", "int8"])
def test_flat_serving_agrees_at_dim_40(odd_setup, mesh8, native_off, rerank_dtype):
    """Flat serving (the fused scan K1) over a bf16 and an int8 table of
    width 40: the JAX kernel in interpret mode and the port's plain version
    return the same top-5."""
    js, ps = _searchers(odd_setup, mesh8, "jax_idx", mode="flat", rerank_dtype=rerank_dtype)
    assert ps.emb_table.shape[1] == DIM and ps.emb_table.dtype == getattr(torch, rerank_dtype)
    _assert_same_results(js.search(QUESTIONS, topk=5), ps.search(QUESTIONS, topk=5))


@pytest.mark.parametrize("index", ["jax_idx", "port_idx"])
def test_sq_ann_with_the_bf16_rerank_agrees_at_dim_40(odd_setup, mesh8, native_off, index):
    """ANN serving over each package's sq index with the bf16 rerank table
    (K4 at dim 40; the JAX searcher's fused Pallas rerank in interpret mode):
    the same top-5, and the same over the exact ANN oracle."""
    js, ps = _searchers(odd_setup, mesh8, index, rerank_dtype="bfloat16")
    assert ps.emb_table.dtype == torch.bfloat16 and ps.emb_table.shape[1] == DIM
    assert ps.rerank_cap == js.rerank_cap == 16
    _assert_same_results(js.search(QUESTIONS, topk=5), ps.search(QUESTIONS, topk=5))
    _assert_same_results(js.search_brute_force(QUESTIONS, topk=5), ps.search_brute_force(QUESTIONS, topk=5))


def test_int8_rerank_table_is_refused_at_dim_40(odd_setup, mesh8, native_off):
    """``serve.rerank_dtype="int8"`` in ANN mode at dim 40: the JAX searcher
    refuses it (its lane-packed int8 table needs whole 128-dim chunks), and
    so does the port (its int8 rerank kernel takes multiples of 16), with a
    ValueError each, before serving anything."""
    cfg, jtok, params, model, tok, tmp = odd_setup
    jcfg, pcfg = _configs(cfg, rerank_dtype="int8")
    with pytest.raises(ValueError, match="multiple of 128"):
        JaxSearcher(jcfg, jtok, params, JaxStorage(tmp / "jax_idx"), mesh=mesh8)
    with pytest.raises(ValueError, match="multiple of 16"):
        ColbertSearcher(pcfg, tok, model, IndexStorage(tmp / "jax_idx"), device="cpu")
