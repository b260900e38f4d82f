"""The port's flat-serving slice against the JAX package, end to end on the CPU.

Reuses ``tests/test_flat_serving.py``'s tiny configuration (fp32, hidden
32, multiview 4/8).  Both packages get the same parameters (the JAX init,
converted) and the same corpus; the port runs its plain PyTorch paths.

Tolerances: written parts are fp16, so the encoders agree within 2e-3; the
served fp32 scores agree within 1e-5.
"""

import socket

import numpy as np
import pytest
import torch

from colbert_tpu.ranking import ColbertSearcher as JaxSearcher
from colbert_tpu.serving import RetrievalService as JaxService
from colbert_tpu_torch.indexing.encoder import CollectionEncoder
from colbert_tpu_torch.indexing.storage import IndexStorage
from colbert_tpu_torch.models.colbert import ColbertModel
from colbert_tpu_torch.models.convert import state_dict_from_jax_params
from colbert_tpu_torch.ranking.searcher import ColbertSearcher
from colbert_tpu_torch.serving.server import (
    RetrievalClient, RetrievalServer, RetrievalService, evaluate_retrieval,
)
from colbert_tpu_torch.tokenization import ColbertTokenizer
from tests.test_end_to_end import corpus_texts
from tests.test_flat_serving import QUERIES, _encode_only

QUESTIONS = QUERIES + ["apple", "forest tree marble", "doc7 dragon", "", "silver wave"]


@pytest.fixture(autouse=True)
def jax_native_off(monkeypatch):
    """The JAX package takes its numpy fallbacks, which compute the same
    functions: its tracked native library is compiled with -march=native
    for another CPU and can stop the test process with an illegal
    instruction."""
    import colbert_tpu.native.lib as native

    monkeypatch.setattr(native, "_load", lambda: None)


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory, mesh8):
    tmp = tmp_path_factory.mktemp("slice")
    texts = corpus_texts(70)
    cfg, jtok, params, jstorage = _encode_only(tmp, mesh8, texts)
    model = ColbertModel(cfg.model, cfg.multiview)
    model.load_state_dict(state_dict_from_jax_params(params, cfg.model))
    tok = ColbertTokenizer(cfg.tokenizer, cfg.multiview)
    return cfg, texts, jtok, params, jstorage, model, tok, tmp


def test_encoders_write_the_same_parts(slice_setup):
    cfg, texts, _, _, jstorage, model, tok, tmp = slice_setup
    storage = CollectionEncoder(cfg, tok, model, device="cpu").encode_corpus(
        texts, str(tmp / "port_idx"), batch_size=8
    )
    assert storage.read_meta() == jstorage.read_meta()
    assert storage.part_ids() == jstorage.part_ids() == [0, 1]
    for p in storage.part_ids():
        assert storage.read_doclens(p) == jstorage.read_doclens(p)
        a, b = storage.read_part(p), jstorage.read_part(p)
        assert a.dtype == b.dtype == np.float16 and a.shape == b.shape
        np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), rtol=0, atol=2e-3)


def test_encoders_compact_ragged_docs_alike(tmp_path, mesh8):
    """Non-multiview docs keep only their active (scored) positions."""
    # varied lengths, and punctuation that the active mask drops
    texts = [t + "," * (i % 3) + " more" * (i % 4) + "." for i, t in enumerate(corpus_texts(20))]
    cfg, _, params, jstorage = _encode_only(tmp_path, mesh8, texts, multiview=False)
    model = ColbertModel(cfg.model, cfg.multiview)
    model.load_state_dict(state_dict_from_jax_params(params, cfg.model))
    tok = ColbertTokenizer(cfg.tokenizer, cfg.multiview)
    storage = CollectionEncoder(cfg, tok, model, device="cpu").encode_corpus(
        texts, str(tmp_path / "port_idx"), batch_size=8
    )
    assert storage.read_meta() == jstorage.read_meta()
    assert storage.read_doclens() == jstorage.read_doclens()
    assert len(set(storage.read_doclens())) > 1
    np.testing.assert_allclose(storage.load_all_embeddings().astype(np.float32),
                               jstorage.load_all_embeddings().astype(np.float32), rtol=0, atol=2e-3)


def test_service_matches_jax_service(slice_setup, mesh8):
    cfg, texts, jtok, params, jstorage, model, tok, _ = slice_setup
    jax_service = JaxService(JaxSearcher(cfg, jtok, params, jstorage, mesh=mesh8), texts)
    # the port serves the parts the JAX encoder wrote
    searcher = ColbertSearcher(cfg, tok, model, IndexStorage(jstorage.path), device="cpu")
    service = RetrievalService(searcher, texts)
    want = jax_service.retrieve(QUESTIONS, topk=5)
    got = service.retrieve(QUESTIONS, topk=5)
    assert len(got) == len(want) == len(QUESTIONS)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 5
        np.testing.assert_allclose([s for _, s, _ in g], [s for _, s, _ in w], rtol=0, atol=1e-5)
        for (gp, gs, gt), (wp, ws, _) in zip(g, w):
            assert gt == texts[gp]
            assert gp == wp or abs(gs - ws) <= 1e-5  # a pid may differ only at a tie


def test_socket_round_trip_equals_in_process(slice_setup):
    cfg, texts, _, _, jstorage, model, tok, _ = slice_setup
    service = RetrievalService(
        ColbertSearcher(cfg, tok, model, IndexStorage(jstorage.path), device="cpu"), texts
    )
    server = RetrievalServer(service, host="127.0.0.1", port=0)
    thread = server.start_background()
    assert server.ready.wait(timeout=10)
    client = RetrievalClient(*server.address, cfg.serve.authkey.encode())
    try:
        # a client that drops during the handshake must not stop the server
        socket.create_connection(server.address, timeout=5).close()
        assert client.retrieve(QUESTIONS, topk=5) == service.retrieve(QUESTIONS, topk=5)
        with pytest.raises(RuntimeError, match="error|Error"):
            client.retrieve(["q"], topk=-3)
        metrics = evaluate_retrieval(
            lambda qs, k: client.retrieve(qs, topk=k),
            [{"question": texts[3], "positive_ctxs": [texts[3]]}], topk=5,
        )
        assert set(metrics) == {"mrr@10", "recall@50", "recall@100"}
    finally:
        client.shutdown()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_searcher_refuses_unported_modes(slice_setup):
    """ANN mode needs the IVF index that ``build-index`` writes
    (``tests/test_torch_ann_slice.py``).  The host-RAM rerank table is an
    ANN mode (``tests/test_torch_ragged_ann.py``): flat mode serves its own
    table whatever ``serve.rerank_table`` says, as the JAX searcher does."""
    import dataclasses

    cfg, texts, _, _, jstorage, model, tok, _ = slice_setup
    host = ColbertSearcher(dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, rerank_table="host")),
                           tok, model, IndexStorage(jstorage.path), device="cpu")
    flat = ColbertSearcher(cfg, tok, model, IndexStorage(jstorage.path), device="cpu")
    assert host.host_table is None
    np.testing.assert_array_equal(host.search(QUESTIONS, topk=5).scores, flat.search(QUESTIONS, topk=5).scores)
    with pytest.raises(FileNotFoundError):
        ColbertSearcher(dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, mode="ann")),
                        tok, model, IndexStorage(jstorage.path), device="cpu")


def test_unfused_route_matches_fused(slice_setup):
    """``flat_fused_topk=False`` (K2 + segmented top-k) serves the same answers."""
    import dataclasses

    cfg, texts, _, _, jstorage, model, tok, _ = slice_setup
    fused = ColbertSearcher(cfg, tok, model, IndexStorage(jstorage.path), device="cpu")
    cfg2 = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, flat_fused_topk=False))
    plain = ColbertSearcher(cfg2, tok, model, IndexStorage(jstorage.path), device="cpu")
    a, b = fused.search(QUESTIONS, topk=5), plain.search(QUESTIONS, topk=5)
    np.testing.assert_allclose(a.scores, b.scores, rtol=0, atol=0)
    assert torch.is_tensor(fused.emb_table) and fused.emb_table.device.type == "cpu"
