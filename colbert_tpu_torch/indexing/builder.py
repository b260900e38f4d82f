"""IVF index build with the sq, pq4 or pq codec.

Counterpart of ``colbert_tpu/indexing/builder.py``: train the coarse
k-means and the codec (the sq projection, or PQ codebooks at 8 bits (pq)
or 4 bits (pq4)) on a sample (parts ``0 .. train_sample_parts-1``, at most
``max_train_points`` rows drawn with ``np.random.default_rng(0)``), assign
and encode every embedding on the device, CSR-pack on the host, and write
the same ``ivf/*.npy`` files and ``meta.json`` keys.  Codes are ``pq_m``
uint8 per row (pq), ``pq4_m / 2`` int8 holding two nibbles each (pq4) or
``sq_dim`` int8 (sq).  The partition count follows the reference formula
when unset: ``1 << round(log2(8 * sqrt(num_embeddings)))``.

The k-means and PQ initialisations draw from one ``torch.Generator``
seeded with ``train.seed``; the JAX package draws from ``jax.random``, so
the two packages build different (equally valid) indexes from one corpus.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from colbert_tpu_torch.config import ColbertConfig
from colbert_tpu_torch.indexing.storage import IndexStorage
from colbert_tpu_torch.ops.ivf import balanced_assign, ivf_pack
from colbert_tpu_torch.ops.kmeans import assign_clusters, kmeans, nearest_centroids
from colbert_tpu_torch.ops.pq import pq_encode, pq_train
from colbert_tpu_torch.ops.pq4 import pq4_encode_packed, pq4_train
from colbert_tpu_torch.ops.sq import sq_encode, sq_train
from colbert_tpu_torch.utils.logging import Timers, get_logger

logger = get_logger("builder")


def auto_partitions(num_embeddings: int) -> int:
    return 1 << round(math.log2(8 * math.sqrt(max(1, num_embeddings))))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class IndexBuilder:
    def __init__(self, cfg: ColbertConfig, storage: IndexStorage, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.storage = storage
        self.device = torch.device(device)
        self.timers = Timers()

    def build(self, generator: Optional[torch.Generator] = None, chunk: int = 16384) -> None:
        c = self.cfg.index
        if c.codec not in ("pq", "pq4", "sq"):
            raise ValueError(f"unknown index.codec {c.codec!r}")
        gen = generator if generator is not None else torch.Generator().manual_seed(self.cfg.train.seed)
        dev = self.device
        meta = self.storage.read_meta()
        doclens = self.storage.read_doclens()
        num_embeddings = int(np.sum(doclens))
        partitions = c.partitions or auto_partitions(num_embeddings)
        partitions = min(partitions, max(1, num_embeddings))
        logger.info("building IVF-%s: N=%d K=%d", c.codec.upper(), num_embeddings, partitions)

        sample_parts = self.storage.part_ids()[: c.train_sample_parts]
        sample = self.storage.load_all_embeddings(sample_parts).astype(np.float32)
        if sample.shape[0] > c.max_train_points:
            idx = np.random.default_rng(0).choice(sample.shape[0], c.max_train_points, replace=False)
            sample = sample[idx]
        x = torch.from_numpy(sample).to(dev)
        kc = min(chunk, max(256, sample.shape[0]))
        with self.timers.span("kmeans_coarse"):
            centroids, _ = kmeans(x, partitions, iters=c.kmeans_iters, generator=gen, chunk=kc)
            _sync(dev)
        codebooks = sq_proj = sq_scales = None
        if c.codec == "pq":
            with self.timers.span("pq_train"):
                codebooks = pq_train(x, c.pq_m, 2 ** c.pq_nbits, iters=c.pq_kmeans_iters, generator=gen, chunk=kc)
                _sync(dev)
            encode = lambda e: pq_encode(e, codebooks, chunk=chunk)
            code_width, code_dtype = c.pq_m, np.uint8
        elif c.codec == "pq4":
            with self.timers.span("pq4_train"):
                codebooks = pq4_train(x, c.pq4_m, iters=c.pq_kmeans_iters, generator=gen, chunk=kc)
                _sync(dev)
            encode = lambda e: pq4_encode_packed(e, codebooks, chunk=chunk)
            code_width, code_dtype = c.pq4_m // 2, np.int8
        else:
            with self.timers.span("sq_train"):
                sq_proj, sq_scales = sq_train(x, c.sq_dim)
                _sync(dev)
            encode = lambda e: sq_encode(e, sq_proj, sq_scales, chunk=chunk)
            code_width, code_dtype = c.sq_dim, np.int8
        del x

        balanced = c.balance_factor > 0 and partitions > 1
        n_cand = min(c.balance_candidates, partitions) if balanced else 1
        cand_all = np.empty((num_embeddings, n_cand), np.int32) if balanced else None
        assignments = np.empty(num_embeddings, np.int32)
        codes = np.empty((num_embeddings, code_width), code_dtype)
        pos = 0
        with self.timers.span("assign_encode"):
            for part in self.storage.part_ids():
                embs = torch.from_numpy(np.array(self.storage.read_part(part))).to(dev)
                n = embs.shape[0]
                if n == 0:
                    continue
                if balanced:
                    cand_all[pos : pos + n] = nearest_centroids(embs, centroids, n_cand, chunk=chunk).cpu().numpy()
                else:
                    assignments[pos : pos + n] = assign_clusters(embs, centroids, chunk=chunk).cpu().numpy()
                codes[pos : pos + n] = encode(embs).cpu().numpy()
                pos += n
        if pos != num_embeddings:
            raise ValueError(f"parts hold {pos} rows, doclens say {num_embeddings}")
        if balanced:
            cap_rows = max(1, int(np.ceil(num_embeddings / partitions * c.balance_factor)))
            with self.timers.span("balanced_assign"):
                assignments = balanced_assign(cand_all, partitions, cap_rows)
            lens0 = np.bincount(cand_all[:, 0], minlength=partitions)
            lens1 = np.bincount(assignments, minlength=partitions)
            logger.info("balanced assignment (cap=%d): list max %d -> %d", cap_rows,
                        int(lens0.max()), int(lens1.max()))

        with self.timers.span("csr_pack"):
            perm, offsets, codes_sorted = ivf_pack(assignments, codes, partitions)
            emb2pid = IndexStorage.emb2pid_from_doclens(doclens)
        host = lambda t: None if t is None else t.cpu().numpy()
        self.storage.write_ivf(
            centroids.cpu().numpy(), codes_sorted, perm, offsets, emb2pid,
            codebooks=host(codebooks), sq_proj=host(sq_proj), sq_scales=host(sq_scales),
        )
        meta.update({
            "partitions": partitions,
            "codec": c.codec,
            "pq_m": c.pq_m,
            "pq_nbits": c.pq_nbits,
            "sq_dim": c.sq_dim,
            "pq4_m": c.pq4_m,
            "bytes_per_vector": {"pq": c.pq_m * c.pq_nbits // 8, "pq4": c.pq4_m // 2, "sq": c.sq_dim}[c.codec],
            "build_timers": self.timers.as_dict(),
        })
        self.storage.write_meta(meta)
        logger.info("index built: %s", {k: v for k, v in meta.items() if k != "build_timers"})
