"""Encoding and flat serving of the port at ``mesh.model=2`` (tensor
parallelism over two CPU positions) against the JAX package at mesh ``data
1 x model 2`` and the port's own ``model = 1``, on the CPU, at the tiny size
of ``tests/test_flat_serving.py`` (fp32, hidden 32, 2 heads, multiview 4/8).

* ``CollectionEncoder`` over two data positions of a model group each (a
  2 x 2 mesh): part files equal to the port's one-device ones within fp16
  rounding (1e-3), to the JAX encoder's at mesh 1 x 2 within 2e-3;
* ``ColbertSearcher`` at ``model = 2`` (its default mesh from the config):
  the same pids and scores within 1e-5 as at ``model = 1`` and as the JAX
  searcher at mesh 1 x 2, a pid differing only at a tie;
* the CLI's ``encode`` and ``evaluate`` at ``--set mesh.model=2``.

The sharded searcher and DPR at ``model = 2`` are in
``test_torch_sharded.py`` and ``test_torch_dense.py``.
"""

import copy
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from colbert_tpu.ranking import ColbertSearcher as JaxSearcher
from colbert_tpu_torch.config import ColbertConfig as PortConfig
from colbert_tpu_torch.indexing.encoder import CollectionEncoder
from colbert_tpu_torch.indexing.storage import IndexStorage
from colbert_tpu_torch.models.colbert import ColbertModel
from colbert_tpu_torch.models.convert import reference_state_dict, state_dict_from_jax_params
from colbert_tpu_torch.parallel.mesh import make_mesh
from colbert_tpu_torch.ranking.searcher import ColbertSearcher
from colbert_tpu_torch.tokenization import ColbertTokenizer
from tests.test_end_to_end import corpus_texts
from tests.test_flat_serving import QUERIES, _encode_only

torch.set_num_threads(2)

QUESTIONS = QUERIES + ["apple", "forest tree marble", "doc7 dragon", "silver wave"]
TOPK = 5


@pytest.fixture(autouse=True)
def jax_native_off(monkeypatch):
    """The JAX package's numpy fallbacks (its tracked native library is built
    for another CPU)."""
    import colbert_tpu.native.lib as native

    monkeypatch.setattr(native, "_load", lambda: None)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from colbert_tpu.parallel import make_mesh as jax_make_mesh

    tmp = tmp_path_factory.mktemp("tp_serve")
    texts = corpus_texts(60)
    jmesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    cfg, jtok, params, jstorage = _encode_only(tmp, jmesh, texts)
    pcfg = PortConfig.from_dict(cfg.to_dict())
    pcfg.mesh.data, pcfg.mesh.model = 1, 2
    model = ColbertModel(pcfg.model, pcfg.multiview)
    model.load_state_dict(state_dict_from_jax_params(params, pcfg.model))
    tok = ColbertTokenizer(pcfg.tokenizer, pcfg.multiview)
    jcfg = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, data=1, model=2))
    want = JaxSearcher(jcfg, jtok, params, jstorage, mesh=jmesh).search(QUESTIONS, topk=TOPK)
    return pcfg, texts, model, tok, jstorage, want, tmp


def _one(cfg):
    return dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, model=1))


def _assert_same(got, want, tol=1e-5):
    assert got.pids.shape == want.pids.shape == (len(QUESTIONS), TOPK)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=tol)
    assert ((got.pids == want.pids) | (np.abs(got.scores - want.scores) <= tol)).all()


def test_encoder_at_model_2_writes_the_one_device_parts(served):
    cfg, texts, model, tok, jstorage, _, tmp = served
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    enc = CollectionEncoder(cfg, tok, copy.deepcopy(model), mesh=mesh)
    assert len(enc.replicas) == 1 and enc.model.model_group == (torch.device("cpu"),) * 2
    got = enc.encode_corpus(texts, str(tmp / "tp_idx"), batch_size=8)
    one = CollectionEncoder(_one(cfg), tok, copy.deepcopy(model), device="cpu").encode_corpus(
        texts, str(tmp / "one_idx"), batch_size=8)
    assert got.read_meta() == one.read_meta() == jstorage.read_meta()
    for p in got.part_ids():
        a = got.read_part(p).astype(np.float32)
        assert got.read_doclens(p) == one.read_doclens(p) == jstorage.read_doclens(p)
        np.testing.assert_allclose(a, one.read_part(p).astype(np.float32), rtol=0, atol=1e-3)
        np.testing.assert_allclose(a, jstorage.read_part(p).astype(np.float32), rtol=0, atol=2e-3)


def test_searcher_at_model_2_serves_the_model_1_and_jax_pids(served):
    cfg, _, model, tok, jstorage, want, _ = served
    tp = ColbertSearcher(cfg, tok, copy.deepcopy(model), IndexStorage(jstorage.path), device="cpu")
    assert tp.model.model_group == (torch.device("cpu"),) * 2
    got = tp.search(QUESTIONS, topk=TOPK)
    one = ColbertSearcher(_one(cfg), tok, copy.deepcopy(model), IndexStorage(jstorage.path), device="cpu")
    _assert_same(got, one.search(QUESTIONS, topk=TOPK))
    _assert_same(got, want)


def test_cli_encode_and_evaluate_at_model_2(served, capsys):
    """``encode`` and a local ``evaluate`` with ``--device cpu --set
    mesh.model=2`` from a retriever ``pytorch.bin``: the parts of the
    library's model-2 encoder, metrics equal to the model-1 run's."""
    from colbert_tpu_torch.cli import main

    cfg, texts, model, _, _, _, tmp = served
    torch.save(reference_state_dict(model.state_dict(), cfg.model), tmp / "r.bin")
    (tmp / "corpus.json").write_text(json.dumps(texts))
    (tmp / "eval.json").write_text(json.dumps([{"question": q, "positive_ctxs": [texts[i]]}
                                               for i, q in enumerate(QUESTIONS)]))
    out = {}
    for m in (1, 2):
        c = dataclasses.replace(cfg, index=dataclasses.replace(cfg.index, index_path=str(tmp / f"cli{m}")),
                                mesh=dataclasses.replace(cfg.mesh, model=m))
        c.to_yaml(tmp / f"c{m}.yaml")
        common = ["--config", str(tmp / f"c{m}.yaml"), "--pretrain", str(tmp / "r.bin"), "--device", "cpu"]
        main(["encode", "--corpus", str(tmp / "corpus.json"), *common])
        capsys.readouterr()
        main(["evaluate", "--eval-data", str(tmp / "eval.json"), "--corpus", str(tmp / "corpus.json"),
              "--topk", "5", *common])
        out[m] = json.loads(capsys.readouterr().out)
    a, b = IndexStorage(str(tmp / "cli2")), IndexStorage(str(tmp / "cli1"))
    np.testing.assert_allclose(a.load_all_embeddings().astype(np.float32), b.load_all_embeddings().astype(np.float32),
                               rtol=0, atol=1e-3)
    assert out[2] == out[1]
