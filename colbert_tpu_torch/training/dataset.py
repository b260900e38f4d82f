"""Retrieval training data pipeline: counterpart of
``colbert_tpu/training/dataset.py``, with the same numpy RNG use, so both
packages draw the same batches from the same data and seed.

The reference's data layer (``colbert/training/colbert_dataset.py:14-76``)
is a JSON list of ``{question, positive_ctxs, hard_negative_ctxs}`` with an
identity collate — tokenization happens *inside the model forward on GPU
steps* (``colbert_model.py:80-84``), serializing host work with device work.

Here the sampler + tokenizer run on the host ahead of the device step and
yield dense arrays, so the device does not wait on Python.
Sampling semantics match ``colbert_model.py:56-77``:

* train: 1 uniformly-random positive + 1 of the first ``negative_pool`` (50)
  hard negatives per question;
* eval: first 2 positives (duplicated if only one) + first 8 hard negatives.
"""

from __future__ import annotations

import threading
import queue as queue_mod
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from colbert_tpu_torch.config import TrainConfig
from colbert_tpu_torch.tokenization import ColbertTokenizer
from colbert_tpu_torch.utils.io import load_json


@dataclass
class _ProducerError:
    """An exception of the sampler's producer thread, passed to the consumer."""
    error: BaseException


class RetrievalDataset:
    """Examples: {question, positive_ctxs: [str], hard_negative_ctxs: [str]}."""

    def __init__(self, examples: Sequence[Dict[str, Any]]):
        self.examples = list(examples)

    @classmethod
    def from_json(cls, path: str) -> "RetrievalDataset":
        return cls(load_json(path))

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        return self.examples[i]


@dataclass
class TrainBatch:
    q_ids: np.ndarray
    q_attn: np.ndarray
    q_active: np.ndarray
    d_ids: np.ndarray
    d_attn: np.ndarray
    d_active: np.ndarray


class RetrievalSampler:
    """Deterministic, seeded epoch iterator producing tokenized batches.

    Docs are interleaved per question: [pos..., neg...] x batch, so the
    positive column for question i is ``i * group_size`` (reference labels
    ``positive_idx_per_question = 2*i``, ``colbert_model.py:89``).
    """

    def __init__(
        self,
        dataset: RetrievalDataset,
        tokenizer: ColbertTokenizer,
        cfg: TrainConfig,
        batch_size: int,
        is_eval: bool = False,
        seed: Optional[int] = None,
        drop_last: bool = True,
    ):
        self.ds = dataset
        self.tok = tokenizer
        self.cfg = cfg
        self.batch_size = batch_size
        self.is_eval = is_eval
        self.rng = np.random.default_rng(cfg.seed if seed is None else seed)
        self.drop_last = drop_last

    @property
    def group_size(self) -> int:
        c = self.cfg
        if self.is_eval:
            return c.eval_num_positives + c.eval_num_negatives
        return c.train_num_positives + c.train_num_negatives

    @property
    def num_positives(self) -> int:
        return self.cfg.eval_num_positives if self.is_eval else self.cfg.train_num_positives

    def steps_per_epoch(self) -> int:
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _sample_docs(self, ex: Dict[str, Any]) -> List[str]:
        c = self.cfg
        pos_ctxs = list(ex["positive_ctxs"])
        neg_ctxs = list(ex["hard_negative_ctxs"])
        if not self.is_eval:
            pos = [pos_ctxs[self.rng.integers(len(pos_ctxs))] for _ in range(c.train_num_positives)]
            pool = neg_ctxs[: c.train_negative_pool]
            neg = [pool[self.rng.integers(len(pool))] for _ in range(c.train_num_negatives)]
        else:
            while len(pos_ctxs) < c.eval_num_positives:
                pos_ctxs.append(pos_ctxs[-1])
            pos = pos_ctxs[: c.eval_num_positives]
            while len(neg_ctxs) < c.eval_num_negatives:
                neg_ctxs.append(neg_ctxs[-1])
            neg = neg_ctxs[: c.eval_num_negatives]
        return pos + neg

    def _length_proxy(self) -> np.ndarray:
        """Per-example doc-length proxy (max ctx character length over the
        positives + sampled-negative pool) — cheap, computed once."""
        if getattr(self, "_proxy", None) is None:
            c = self.cfg
            vals = np.empty(len(self.ds), np.int64)
            for i, ex in enumerate(self.ds.examples):
                pool = list(ex["positive_ctxs"]) + list(
                    ex["hard_negative_ctxs"][: c.train_negative_pool]
                )
                vals[i] = max((len(t) for t in pool), default=0)
            self._proxy = vals
        return self._proxy

    def _make_batch(self, idxs: Sequence[int]) -> TrainBatch:
        questions = [self.ds[i]["question"] for i in idxs]
        docs: List[str] = []
        for i in idxs:
            docs += self._sample_docs(self.ds[i])
        q = self.tok.encode_queries(questions)
        d = self.tok.encode_docs(docs)
        d_ids, d_attn, d_active = d.input_ids, d.attention_mask, d.active_mask
        buckets = tuple(self.cfg.doc_length_buckets or ())
        if buckets:
            # truncate the (all-PAD) tail to the smallest bucket that fits
            # the batch's longest doc
            full = d_ids.shape[1]
            longest = int(d_attn.sum(axis=1).max(initial=1))
            L = next((b for b in sorted(buckets) if b >= longest), full)
            L = min(L, full)
            d_ids, d_attn = d_ids[:, :L], d_attn[:, :L]
            if d_active.shape[1] == full:  # token-wise mask (non-multiview)
                d_active = d_active[:, :L]
        return TrainBatch(q.input_ids, q.attention_mask, q.active_mask, d_ids, d_attn, d_active)

    def epoch(self, epoch_idx: int = 0, prefetch: int = 2) -> Iterator[TrainBatch]:
        """Yield tokenized batches; tokenization overlaps the device step via
        a producer thread (replaces the reference's Pool(4)+Queue machinery,
        ``encoder.py:69-84``, with one bounded queue).  An exception in the
        producer goes through the queue and is raised here, in the caller
        (the JAX package's producer dies without its sentinel and leaves the
        consumer waiting)."""
        order = np.arange(len(self.ds))
        if not self.is_eval:
            shuffle_rng = np.random.default_rng(self.cfg.seed + epoch_idx)
            shuffle_rng.shuffle(order)
            if self.cfg.length_group_pool > 0:
                # sort by doc-length proxy within pools of N batches: batches
                # become length-homogeneous, so doc_length_buckets truncation
                # tracks the local length scale (pool order stays shuffled)
                pool = self.cfg.length_group_pool * self.batch_size
                proxy = self._length_proxy()
                for lo in range(0, len(order), pool):
                    seg = order[lo : lo + pool]
                    order[lo : lo + pool] = seg[np.argsort(proxy[seg], kind="stable")]
        n_steps = self.steps_per_epoch()
        q: "queue_mod.Queue" = queue_mod.Queue(maxsize=prefetch)
        sentinel = object()

        def produce():
            try:
                for s in range(n_steps):
                    idxs = order[s * self.batch_size : (s + 1) * self.batch_size]
                    if len(idxs) < self.batch_size and self.drop_last:
                        break
                    q.put(self._make_batch(idxs))
            except BaseException as e:  # noqa: BLE001 -- re-raised by the consumer
                q.put(_ProducerError(e))
                return
            q.put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, _ProducerError):
                t.join()
                raise item.error
            yield item
        t.join()
