"""On-disk index layout: the part and meta half of ``colbert_tpu/indexing/storage.py``.

Same files and the same ``meta.json`` keys, so each package serves the
other's parts::

    index_path/
      meta.json               dims, counts, multiview flag, d_view
      parts/{i}.npy           (sum_doclens_i, dim) fp16 token embeddings
      parts/doclens.{i}.json  per-doc vector counts for part i

A copy rather than an import: ``colbert_tpu.indexing``'s package
``__init__`` imports jax.  The IVF half comes with the ANN slice.
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

    @staticmethod
    def emb2pid_from_doclens(doclens: List[int]) -> np.ndarray:
        """Embedding-row -> passage-id map (reference ``colbert_ranker.py:163-174``)."""
        return np.repeat(np.arange(len(doclens), dtype=np.int32), doclens)

    @staticmethod
    def doc_offsets_from_doclens(doclens: List[int]) -> np.ndarray:
        off = np.zeros(len(doclens) + 1, np.int64)
        np.cumsum(doclens, out=off[1:])
        return off
