"""On-disk index layout: a copy of ``colbert_tpu/indexing/storage.py``.

Same files, dtypes and ``meta.json`` keys, so each package serves the
other's index::

    index_path/
      meta.json                 dims, counts, multiview flag, d_view, codec
      parts/{i}.npy             (sum_doclens_i, dim) fp16 token embeddings
      parts/doclens.{i}.json    per-doc vector counts for part i
      ivf/coarse_centroids.npy  (K, dim) fp32
      ivf/codes.npy             (N, sq_dim) int8   CSR-sorted by list
      ivf/row_emb.npy           (N,) int32         sorted row -> embedding id
      ivf/offsets.npy           (K+1,) int32
      ivf/sq_proj.npy           (dim, sq_dim) fp32 (sq codec)
      ivf/sq_scales.npy         (sq_dim,) fp32     (sq codec)
      emb2pid.npy               (N,) int32         embedding id -> passage id

A copy rather than an import: ``colbert_tpu.indexing``'s package
``__init__`` imports jax.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

from colbert_tpu_torch.utils.io import dump_json, load_json


class IndexStorage:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        (self.path / "parts").mkdir(parents=True, exist_ok=True)
        (self.path / "ivf").mkdir(parents=True, exist_ok=True)

    # ---- metadata ----

    @property
    def meta_path(self) -> Path:
        return self.path / "meta.json"

    def write_meta(self, meta: Dict) -> None:
        dump_json(meta, self.meta_path, indent=2)

    def read_meta(self) -> Dict:
        return load_json(self.meta_path)

    # ---- embedding parts ----

    def write_part(self, part: int, embeddings: np.ndarray, doclens: List[int]) -> None:
        if embeddings.ndim != 2 or embeddings.shape[0] != int(np.sum(doclens)):
            raise ValueError(
                f"part {part}: {embeddings.shape} embeddings for {int(np.sum(doclens))} doc rows"
            )
        np.save(self.path / "parts" / f"{part}.npy", embeddings.astype(np.float16))
        dump_json(doclens, self.path / "parts" / f"doclens.{part}.json")

    def part_ids(self) -> List[int]:
        return sorted(
            int(p.stem) for p in (self.path / "parts").glob("*.npy") if p.stem.isdigit()
        )

    def read_part(self, part: int, mmap: bool = True) -> np.ndarray:
        return np.load(self.path / "parts" / f"{part}.npy", mmap_mode="r" if mmap else None)

    def read_doclens(self, part: Optional[int] = None) -> List[int]:
        if part is not None:
            return load_json(self.path / "parts" / f"doclens.{part}.json")
        out: List[int] = []
        for i in self.part_ids():
            out += load_json(self.path / "parts" / f"doclens.{i}.json")
        return out

    def iter_embeddings(self, parts: Optional[List[int]] = None) -> Iterator[np.ndarray]:
        for i in parts if parts is not None else self.part_ids():
            yield self.read_part(i)

    def load_all_embeddings(self, parts: Optional[List[int]] = None) -> np.ndarray:
        mats = [np.asarray(p) for p in self.iter_embeddings(parts)]
        return np.concatenate(mats, axis=0) if mats else np.zeros((0, 0), np.float16)

    # ---- IVF arrays ----

    def write_ivf(
        self,
        coarse_centroids: np.ndarray,
        codes_sorted: np.ndarray,
        row_emb: np.ndarray,
        offsets: np.ndarray,
        emb2pid: np.ndarray,
        codebooks: Optional[np.ndarray] = None,   # PQ codec
        sq_proj: Optional[np.ndarray] = None,     # SQ codec
        sq_scales: Optional[np.ndarray] = None,
    ) -> None:
        np.save(self.path / "ivf" / "coarse_centroids.npy", coarse_centroids.astype(np.float32))
        np.save(self.path / "ivf" / "codes.npy", codes_sorted)
        np.save(self.path / "ivf" / "row_emb.npy", row_emb.astype(np.int32))
        np.save(self.path / "ivf" / "offsets.npy", offsets.astype(np.int32))
        np.save(self.path / "emb2pid.npy", emb2pid.astype(np.int32))
        if codebooks is not None:
            np.save(self.path / "ivf" / "codebooks.npy", codebooks.astype(np.float32))
        if sq_proj is not None:
            np.save(self.path / "ivf" / "sq_proj.npy", sq_proj.astype(np.float32))
            np.save(self.path / "ivf" / "sq_scales.npy", sq_scales.astype(np.float32))

    def read_ivf(self) -> Dict[str, np.ndarray]:
        p = self.path
        out = {
            "coarse_centroids": np.load(p / "ivf" / "coarse_centroids.npy"),
            "codes": np.load(p / "ivf" / "codes.npy"),
            "row_emb": np.load(p / "ivf" / "row_emb.npy"),
            "offsets": np.load(p / "ivf" / "offsets.npy"),
            "emb2pid": np.load(p / "emb2pid.npy"),
        }
        for name in ("codebooks", "sq_proj", "sq_scales"):
            f = p / "ivf" / f"{name}.npy"
            if f.exists():
                out[name] = np.load(f)
        return out

    @staticmethod
    def emb2pid_from_doclens(doclens: List[int]) -> np.ndarray:
        """Embedding-row -> passage-id map (reference ``colbert_ranker.py:163-174``)."""
        return np.repeat(np.arange(len(doclens), dtype=np.int32), doclens)

    @staticmethod
    def doc_offsets_from_doclens(doclens: List[int]) -> np.ndarray:
        off = np.zeros(len(doclens) + 1, np.int64)
        np.cumsum(doclens, out=off[1:])
        return off
