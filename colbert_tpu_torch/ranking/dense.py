"""Single-vector (DPR-style) dense retriever: counterpart of
``colbert_tpu/ranking/dense.py``.

The reference's ``DPRRetriever`` flow (``faiss_indexers.py:126-158``: one
vector a passage, ``DenseFlatIndexer``'s exact inner-product search).  The
pooled vector is the mean of the ColBERT model's token vectors over the
tokenizer's active mask (the count clamped at 1), L2-normalised (the norm
clamped at 1e-12), fp32 on output, as the JAX package pools it
(``:36-41``); the index is :class:`FlatIndex` on the retriever's device.
Like :class:`~colbert_tpu_torch.ranking.searcher.ColbertSearcher` it takes
a ``ColbertModel`` and a device (the card unless the caller asks for the
CPU).  Texts are encoded in chunks of ``batch`` (256) with no padding: the
JAX package pads a chunk to a multiple of its mesh's data axis, which is 1
here.  At ``mesh.model > 1`` the model is sharded over a model group
(``models/sharding.py::place``), as the JAX package shards its parameters
(``:30-32``), and the pooled vectors come back to the group's first device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from colbert_tpu_torch.config import ColbertConfig
from colbert_tpu_torch.indexing.flat import FlatIndex
from colbert_tpu_torch.models.colbert import ColbertModel
from colbert_tpu_torch.ops.pooling import avg_pool_by_mask
from colbert_tpu_torch.models.sharding import place
from colbert_tpu_torch.parallel.mesh import device_mesh
from colbert_tpu_torch.tokenization import ColbertTokenizer


def pool(t: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """(B, V, dim) token vectors, (B, V) active mask -> (B, dim): the masked
    mean, L2-normalised (JAX ``DenseRetriever._pooled_fn``)."""
    pooled = avg_pool_by_mask(t, active)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-12)


class DenseRetriever:
    def __init__(self, cfg: ColbertConfig, tokenizer: ColbertTokenizer, model: ColbertModel,
                 device: str | torch.device = "cuda"):
        if tokenizer.vocab_size > cfg.model.vocab_size:
            # an id past the embedding table is a device-side assert on the card
            raise ValueError(
                f"tokenizer vocab ({tokenizer.vocab_size}) exceeds model.vocab_size ({cfg.model.vocab_size})"
            )
        self.cfg = cfg
        self.tok = tokenizer
        mesh = device_mesh(device, 1, cfg.mesh.model)
        self.device = mesh.devices[0]
        self.model = place(model, mesh.grid[0]).eval()
        self.index: Optional[FlatIndex] = None

    @torch.inference_mode()
    def _pooled(self, ids: np.ndarray, attn: np.ndarray, active: np.ndarray, is_query: bool) -> torch.Tensor:
        encode = self.model.query if is_query else self.model.doc
        t = encode(torch.from_numpy(ids).to(self.device), torch.from_numpy(attn).to(self.device))
        return pool(t, torch.from_numpy(active).to(self.device))

    def _encode(self, texts: Sequence[str], is_query: bool, batch: int = 256) -> np.ndarray:
        """(len(texts), dim) fp32 pooled vectors, ``batch`` texts a pass."""
        out = []
        enc_fn = self.tok.encode_queries if is_query else self.tok.encode_docs
        for lo in range(0, len(texts), batch):
            e = enc_fn(list(texts[lo : lo + batch]))
            out.append(self._pooled(e.input_ids, e.attention_mask, e.active_mask, is_query).cpu().numpy())
        return np.concatenate(out, axis=0) if out else np.zeros((0, self.cfg.model.dim), np.float32)

    def build_index(self, corpus: Sequence[str], batch: int = 256) -> None:
        self.index = FlatIndex(self._encode(corpus, is_query=False, batch=batch), device=self.device)

    def search(self, questions: Sequence[str], topk: int = 100) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (B, k), passage ids (B, k)), k = min(topk, corpus size)."""
        if self.index is None:
            raise RuntimeError("call build_index (or load) first")
        return self.index.search(self._encode(questions, is_query=True), topk)

    def save_index(self, path: str) -> None:
        self.index.save(path)

    def load_index(self, path: str) -> None:
        self.index = FlatIndex.load(path, device=self.device)
