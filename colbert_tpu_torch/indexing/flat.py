"""Flat (exact inner-product) single-vector index: counterpart of
``colbert_tpu/indexing/flat.py``, the DPR-style baseline.

The reference's ``DenseFlatIndexer`` (``faiss_indexers.py:20-123``: an
``IndexFlatIP``, an id map, serialize and deserialize): one fp32 product of
the queries with every vector (TF32 off, so the scores are fp32 inner
products on the card as on the CPU) and a top-k whose ties go to the lowest
index, as ``jax.lax.top_k``'s (``ops/topk.py``).  The vectors live on the
index's device.  ``save`` and ``load`` use the JAX package's files
(``vectors.npy`` fp32, ``ids.npy``), so each package loads the other's index.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from colbert_tpu_torch.ops.topk import topk as topk_lowest


class FlatIndex:
    def __init__(self, vectors, ids: Optional[np.ndarray] = None, device: str | torch.device = "cuda"):
        """``vectors`` (N, d), any float array or tensor (held as fp32 on
        ``device``); ``ids`` the external id of each row (default 0 .. N-1)."""
        self.device = torch.device(device)
        self.vectors = torch.as_tensor(vectors).to(device=self.device, dtype=torch.float32)
        n = self.vectors.shape[0]
        self.ids = np.arange(n, dtype=np.int64) if ids is None else np.asarray(ids)

    def __len__(self) -> int:
        return int(self.vectors.shape[0])

    def search(self, queries, topk: int) -> Tuple[np.ndarray, np.ndarray]:
        """(B, d) -> (scores (B, k) fp32, external ids (B, k)), k = min(topk, N)."""
        q = torch.as_tensor(queries).to(device=self.device, dtype=torch.float32)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            s = q @ self.vectors.T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        s, i = topk_lowest(s, min(topk, len(self)))
        return s.cpu().numpy(), self.ids[i.cpu().numpy()]

    # ---- persistence (the reference's serialize/deserialize, faiss_indexers.py:38-76) ----

    def save(self, path: str) -> None:
        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        np.save(p / "vectors.npy", self.vectors.cpu().numpy().astype(np.float32))
        np.save(p / "ids.npy", self.ids)

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda") -> "FlatIndex":
        p = Path(path)
        return cls(np.load(p / "vectors.npy"), np.load(p / "ids.npy"), device=device)
