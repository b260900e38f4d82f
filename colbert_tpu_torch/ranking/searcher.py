"""Flat serving searcher: counterpart of the flat branch of
``colbert_tpu/ranking/searcher.py`` (``:361-426, 575-619, 682-734``).

    query tokens -> BERT + ColBERT head -> mask (+ int8 descale)
                 -> flat scan kernel -> exact top-k

The doc-major table is built once from the encoded parts and held on the
device; nothing of the serve path runs anywhere else.  ANN serving and the
host-RAM rerank table are later slices of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from colbert_tpu_torch.config import ColbertConfig
from colbert_tpu_torch.utils.logging import Timers
from colbert_tpu_torch.indexing.storage import IndexStorage
from colbert_tpu_torch.models.colbert import ColbertModel
from colbert_tpu_torch.ops.flat_scan import (
    build_flat_table, flat_maxsim_scan, flat_scan_topk, flat_topk,
)
from colbert_tpu_torch.tokenization import ColbertTokenizer


@dataclass
class SearchResult:
    pids: np.ndarray    # (B, topk) int32, -1 padded
    scores: np.ndarray  # (B, topk) fp32


class PendingResult:
    """``(scores, pids)`` of a dispatched batch, copied to pinned host memory
    without waiting; iterating it waits for that copy only and yields numpy
    arrays (the async serving path of :meth:`ColbertSearcher.search_tokens_device`)."""

    def __init__(self, scores: torch.Tensor, pids: torch.Tensor):
        self._event = None
        if scores.is_cuda:
            pinned = lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._scores, self._pids = pinned(scores), pinned(pids)
            self._scores.copy_(scores, non_blocking=True)
            self._pids.copy_(pids, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._scores, self._pids = scores, pids

    def __iter__(self):
        if self._event is not None:
            self._event.synchronize()
        return iter((self._scores.numpy(), self._pids.numpy()))


def _meta_d_view(meta: dict, cfg: ColbertConfig) -> int:
    """The index's stored rows-per-doc, validated against the serving config
    (a mismatch would silently misalign the doc-major table)."""
    stored = meta.get("d_view")
    if stored is None:
        return cfg.multiview.d_view
    if int(stored) != cfg.multiview.d_view:
        raise ValueError(
            f"index was built with d_view={stored} but the serving config has "
            f"multiview.d_view={cfg.multiview.d_view}; these must match"
        )
    return int(stored)


class ColbertSearcher:
    def __init__(
        self,
        cfg: ColbertConfig,
        tokenizer: ColbertTokenizer,
        model: ColbertModel,
        storage: IndexStorage,
        device: str | torch.device = "cuda",
    ):
        if cfg.serve.mode != "flat":
            raise NotImplementedError(
                f"serve.mode={cfg.serve.mode!r}: the port serves flat mode only; "
                "ANN serving is ROADMAP Queue 1 step 8 (ANN serve)"
            )
        if cfg.serve.rerank_table != "hbm":
            raise NotImplementedError(
                "serve.rerank_table='host' is not ported: ROADMAP Queue 1 step 8 "
                "(ANN serve, host-table rerank mode)"
            )
        if tokenizer.vocab_size > cfg.model.vocab_size:
            # an id past the embedding table is a device-side assert on the card
            raise ValueError(
                f"tokenizer vocab ({tokenizer.vocab_size}) exceeds model.vocab_size ({cfg.model.vocab_size})"
            )
        self.cfg = cfg
        self.tok = tokenizer
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.timers = Timers()

        meta = storage.read_meta()
        doclens = np.asarray(storage.read_doclens(), np.int32)
        self.num_docs = len(doclens)
        self.dim = int(meta["dim"])
        dv = (
            _meta_d_view(meta, cfg)
            if meta.get("multiview", True)
            else (int(doclens.max()) if len(doclens) else 1)
        )
        dtype = "int8" if cfg.serve.rerank_dtype == "int8" else "bfloat16"
        table, inv, dv = build_flat_table(
            storage.load_all_embeddings(), doclens, dv=dv, dtype=dtype,
            rows_blk=cfg.serve.flat_rows_block or None,
        )
        self.flat_dv = dv
        self.emb_table = table.to(self.device)
        self.emb_inv_scale = inv.to(self.device) if inv is not None else None
        self.score_dtype = cfg.serve.flat_score_dtype
        if self.score_dtype == "auto":
            # fp32 scores up to 256k docs (tie-exact at negligible memory);
            # bf16 above (halves the score matrix)
            self.score_dtype = "float32" if self.num_docs <= (1 << 18) else "bfloat16"

    # ---- device pipeline ----

    @torch.inference_mode()
    def encode_queries(self, q_ids, q_attn, q_active) -> torch.Tensor:
        """Masked query reps ``(B, q_view, dim)`` fp32, descaled for an int8 table."""
        dev = self.device
        Q = self.model.query(torch.as_tensor(q_ids).to(dev), torch.as_tensor(q_attn).to(dev))
        Qm = Q * torch.as_tensor(q_active).to(dev, Q.dtype)[..., None]
        if self.emb_inv_scale is not None:
            Qm = Qm * self.emb_inv_scale
        return Qm

    @torch.inference_mode()
    def _search_flat(self, q_ids, q_attn, q_active, topk: int) -> Tuple[torch.Tensor, torch.Tensor]:
        Qm = self.encode_queries(q_ids, q_attn, q_active)
        s = self.cfg.serve
        if s.flat_fused_topk:
            return flat_scan_topk(
                Qm, self.emb_table, dv=self.flat_dv, num_docs=self.num_docs,
                topk=topk, score_dtype=self.score_dtype,
            )
        scores = flat_maxsim_scan(Qm, self.emb_table, dv=self.flat_dv)
        return flat_topk(scores, self.num_docs, topk, segment=s.flat_segment_docs)

    # ---- public API ----

    def search(self, questions: Sequence[str], topk: Optional[int] = None,
               nprobe: Optional[int] = None, depth: Optional[int] = None) -> SearchResult:
        enc = self.tok.encode_queries(list(questions))
        return self.search_tokens(enc.input_ids, enc.attention_mask, enc.active_mask, topk=topk)

    def search_tokens(self, q_ids, q_attn, q_active, topk: Optional[int] = None,
                      nprobe: Optional[int] = None, depth: Optional[int] = None) -> SearchResult:
        """Search from pre-tokenized queries; ``nprobe``/``depth`` are ANN
        knobs that flat mode ignores, as the JAX searcher does."""
        with self.timers.span("search"):
            ts, tp = self.search_tokens_device(q_ids, q_attn, q_active, topk=topk)
        return SearchResult(tp, ts)

    def search_tokens_device(self, q_ids, q_attn, q_active, topk: Optional[int] = None,
                             nprobe: Optional[int] = None, depth: Optional[int] = None
                             ) -> PendingResult:
        """Dispatch a batch and return a handle that synchronises only when
        unpacked: submitting the next batch before fetching this one overlaps
        host work with the device."""
        ts, tp = self._search_flat(q_ids, q_attn, q_active, topk or self.cfg.serve.topk)
        return PendingResult(ts, tp)
