"""Corpus encoder: counterpart of ``colbert_tpu/indexing/encoder.py``.

A producer thread tokenizes ahead on the host while the doc encoder runs
on the device; each corpus part is written once, as fp16 token embeddings
plus per-doc lengths, in the same layout and ``meta.json`` as the JAX
encoder (``indexing/storage.py``).  Embeddings are compacted with the
active mask before storage: multiview docs keep their ``d_view`` vectors,
other docs only their scored (non-punctuation, non-[SEP]) positions.

Over the mesh's ``data`` axis (JAX ``:60-75``): each batch is padded to a
multiple of the positions and split into equal contiguous parts, one a
position, each encoded by the model replica on that position's device;
the parts are put back in order, so the part files equal one device's.
Each data position holds a model group (``mesh.model`` positions): its
replica is sharded over them (``models/sharding.py::place``), the reps come
back to the group's first device.  Under a launch
(``parallel/mesh.py::init_distributed``) the positions are the ranks'
(one model group each): each rank encodes its part, the parts are
all-gathered, and rank 0 alone writes the parts and ``meta.json``.
"""

from __future__ import annotations

import copy
import queue as queue_mod
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from colbert_tpu_torch.config import ColbertConfig
from colbert_tpu_torch.utils.logging import Timers, get_logger
from colbert_tpu_torch.indexing.storage import IndexStorage
from colbert_tpu_torch.models.colbert import ColbertModel
from colbert_tpu_torch.models.sharding import place
from colbert_tpu_torch.parallel.collectives import all_gather_rows, barrier, world
from colbert_tpu_torch.parallel.mesh import Mesh
from colbert_tpu_torch.tokenization import ColbertTokenizer

logger = get_logger("encoder")


class CollectionEncoder:
    def __init__(self, cfg: ColbertConfig, tokenizer: ColbertTokenizer, model: ColbertModel,
                 device: str | torch.device = "cuda", mesh: Optional[Mesh] = None):
        """``mesh``: the data positions to split each batch over, each with
        its model group (default: ``device`` alone)."""
        if tokenizer.vocab_size > cfg.model.vocab_size:
            # an id past the embedding table is a device-side assert on the card
            raise ValueError(
                f"tokenizer vocab ({tokenizer.vocab_size}) exceeds model.vocab_size ({cfg.model.vocab_size})"
            )
        self.cfg = cfg
        self.tok = tokenizer
        self.mesh = mesh if mesh is not None else Mesh.of([device])
        self.device = self.mesh.devices[0]
        self.model = place(model, self.mesh.grid[0]).eval()
        # one replica a distinct model group
        self.replicas = {self.mesh.grid[0]: self.model}
        for group in self.mesh.grid:
            if group not in self.replicas:
                self.replicas[group] = place(copy.deepcopy(self.model), group)
        self.rank, self.world = world()
        self.timers = Timers()

    # ---- device step ----

    @torch.inference_mode()
    def _encode_tokenized(self, ids, attn, active) -> Tuple[np.ndarray, List[int]]:
        """One tokenized batch -> (flat compacted embeddings fp16, doclens)."""
        dev = self.device
        n, positions = ids.shape[0], self.mesh.data
        per = -(-n // (positions * self.world))  # rows a position
        pad = ((0, per * positions * self.world - n), (0, 0))
        ids, attn = np.pad(ids, pad), np.pad(attn, pad)
        parts = []
        for j, group in enumerate(self.mesh.grid):
            lo, d = (self.rank * positions + j) * per, group[0]
            parts.append(self.replicas[group].doc(torch.from_numpy(ids[lo : lo + per]).to(d),
                                                  torch.from_numpy(attn[lo : lo + per]).to(d)).to(torch.float16))
        D = all_gather_rows(torch.cat([x.to(dev) for x in parts]))[:n]  # (B, V, dim)
        if self.cfg.multiview.enabled:
            # static d_view vectors per doc, all active
            return D.reshape(-1, D.shape[-1]).cpu().numpy(), [D.shape[1]] * D.shape[0]
        mask = torch.from_numpy(active).to(dev).bool()
        flat = D[mask]                                            # row-major: doc by doc
        return flat.cpu().numpy(), mask.sum(dim=1).tolist()

    # ---- corpus pipeline ----

    def encode_corpus(
        self,
        texts: Sequence[str],
        index_path: str,
        num_parts: Optional[int] = None,
        batch_size: Optional[int] = None,
        prefetch: int = 2,
    ) -> IndexStorage:
        """Encode the whole corpus into part files under ``index_path``."""
        cfg = self.cfg.index
        num_parts = num_parts or cfg.num_parts
        batch_size = batch_size or cfg.encode_batch_size
        storage = IndexStorage(index_path)
        n = len(texts)
        bounds = [(p * n) // num_parts for p in range(num_parts + 1)]

        q: "queue_mod.Queue" = queue_mod.Queue(maxsize=prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def produce():
            try:
                for p in range(num_parts):
                    lo, hi = bounds[p], bounds[p + 1]
                    for s in range(lo, hi, batch_size):
                        enc = self.tok.encode_docs([texts[i] for i in range(s, min(hi, s + batch_size))])
                        if not put((p, enc.input_ids, enc.attention_mask, enc.active_mask)):
                            return
            except Exception as e:  # noqa: BLE001 -- handed to the consumer, which raises it
                put(e)
                return
            put(sentinel)

        t = threading.Thread(target=produce, daemon=True, name="encode-tokenizer")
        t.start()

        cur_part, embs, doclens = 0, [], []

        def flush(part):
            nonlocal embs, doclens
            flat = np.concatenate(embs, axis=0) if embs else np.zeros((0, self.cfg.model.dim), np.float16)
            if not self.rank:
                storage.write_part(part, flat, doclens)
                logger.info("part %d: %d docs, %d vectors", part, len(doclens), flat.shape[0])
            embs, doclens = [], []

        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                p, ids, attn, active = item
                if p != cur_part:
                    flush(cur_part)
                    cur_part = p
                with self.timers.span("encode_batch"):
                    flat, dl = self._encode_tokenized(ids, attn, active)
                embs.append(flat)
                doclens += dl
            flush(cur_part)
        finally:
            stop.set()
            t.join()

        if not self.rank:
            storage.write_meta(
                {
                    "dim": self.cfg.model.dim,
                    "num_docs": n,
                    "num_embeddings": int(np.sum(storage.read_doclens())),
                    "multiview": self.cfg.multiview.enabled,
                    "d_view": self.cfg.multiview.d_view,
                    "num_parts": num_parts,
                    "embedding_dtype": "float16",
                }
            )
        barrier()  # the other ranks return once the files are there
        return storage
