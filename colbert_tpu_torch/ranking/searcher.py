"""Searcher: counterpart of ``colbert_tpu/ranking/searcher.py``.

Two serving modes, as ``serve.mode`` selects:

* flat (``:361-426, 575-619``): query tokens -> BERT + ColBERT head ->
  mask (+ int8 descale) -> flat scan kernel (K1/K2) -> exact top-k, over a
  doc-major table built from the encoded parts;
* ann (``:89-357, 428-571``): query tokens -> BERT + ColBERT head -> the
  codec's IVF probe (sq: K6 slots and K7 hot lists, or K10 per token with
  ``serve.probe_impl="token"``; pq4: K8; pq: an fp32 LUT gather in torch
  ops) -> CSR row -> pid -> dedup -> exact MaxSim rerank -> top-k, over the
  IVF index that ``build-index`` writes.  ``serve.rerank_dtype`` picks the
  rerank table: "bfloat16" (K4, the fused gather + MaxSim kernel), "int8"
  (K5) or "float32": an fp32 table reranked by a gather and an fp32 einsum
  in torch ops (:func:`rerank_fp32`), as the JAX package reranks an fp32
  table off the TPU (its XLA branch, ``:310-328``).

The index and the tables are built once and held on the device; nothing of
the serve path runs anywhere else.  The JAX package's ``serve.rerank_kernel``
gate (Pallas kernel or XLA gather for a bf16 table) is a TPU-side choice and
changes nothing here.  Flat mode serves "float32" from a bf16 table, as the
JAX flat path does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from colbert_tpu_torch.config import ColbertConfig
from colbert_tpu_torch.utils.logging import Timers
from colbert_tpu_torch.indexing.storage import IndexStorage
from colbert_tpu_torch.models.colbert import ColbertModel
from colbert_tpu_torch.ops.flat_scan import (
    build_flat_table, flat_maxsim_scan, flat_scan_topk, flat_topk,
)
from colbert_tpu_torch.ops.ivf import (
    dedup_pids_by_approx_maxsim, dedup_pids_by_score, ivf_probe_adc, ivf_probe_sq, ivf_probe_sq_batched,
)
from colbert_tpu_torch.ops.pq4 import ivf_probe_pq4
from colbert_tpu_torch.ops.rerank import (
    maxsim_rerank_uniform, maxsim_rerank_uniform_int8, quantize_emb_table,
)
from colbert_tpu_torch.tokenization import ColbertTokenizer

ProbeFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
_ORACLE_DOCS = 4096  # docs per step of the exact oracle
_FP32_QUERY_CHUNK = 8  # queries per step of the fp32 rerank (the JAX searcher's query_chunk)


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


def select_topk(scores: torch.Tensor, cand: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row, the ``k`` best scores (ties: the earlier column first, as
    ``top_k``) and their candidates, -1 where the score is not finite."""
    ts, ti = torch.sort(scores, dim=1, descending=True, stable=True)
    ts = ts[:, :k]
    tp = cand.gather(1, ti[:, :k])
    return ts, torch.where(torch.isfinite(ts), tp, -1).int()


# ---- the ANN pipeline after query encode ----

def make_probe_fn(codec: str, coarse, quant, codes, offsets, *, nprobe: int, cap: int, depth: int,
                  probe_impl: str = "auto", list_topr: int = 8, hot_cap: int = 64) -> ProbeFn:
    """The codec's candidate generator for :func:`retrieval_core`
    (``colbert_tpu/ranking/searcher.py:89``).  ``quant``: the codebooks
    (pq, pq4) or ``(sq_proj, sq_scales)`` (sq); ``cap``: the longest list.
    pq ignores ``probe_impl``; pq4 keeps ``list_topr`` rows per (token,
    list); sq scans list-major (K6/K7) for "auto"/"batched" and per token
    (K10) for "token"."""
    if codec == "pq":
        return lambda tokens: ivf_probe_adc(tokens, coarse, quant, codes, offsets,
                                            nprobe=nprobe, cap=cap, depth=depth)
    if codec == "pq4":
        return lambda tokens: ivf_probe_pq4(tokens, coarse, quant, codes, offsets,
                                            nprobe=nprobe, depth=depth, r=list_topr)
    if codec != "sq":
        raise ValueError(f"unknown index codec {codec!r}")
    proj, scales = quant
    if probe_impl == "token":
        return lambda tokens: ivf_probe_sq(tokens, coarse, proj, scales, codes, offsets,
                                           nprobe=nprobe, cap=cap, depth=depth)
    if probe_impl not in ("auto", "batched"):
        raise ValueError(f"unknown serve.probe_impl {probe_impl!r}")
    return lambda tokens: ivf_probe_sq_batched(
        tokens, coarse, proj, scales, codes, offsets,
        nprobe=nprobe, depth=depth, r=list_topr, hot_cap=hot_cap,
    )


def probe_pids(Qm: torch.Tensor, qm: torch.Tensor, probe_fn: ProbeFn, pid_by_row: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe every query token; map CSR rows to pids; dead (masked) tokens
    contribute nothing.  Returns (pids, codec scores), each (B, qv*depth)."""
    B, q_view, dim = Qm.shape
    scores, rows = probe_fn(Qm.reshape(B * q_view, dim))
    pids = torch.where(rows >= 0, pid_by_row[rows.clamp(min=0).long()], -1)
    live = (qm.reshape(B * q_view) > 0)[:, None]
    pids = torch.where(live, pids, -1)
    scores = torch.where(live, scores, float("-inf"))
    return pids.view(B, -1), scores.view(B, -1)


def dedup(pids: torch.Tensor, scores: torch.Tensor, *, q_view: int, depth: int, max_cand: int,
          candidate_ranking: str = "approx_maxsim", dedup_impl: str = "auto") -> torch.Tensor:
    """Each query's ``max_cand`` candidate pids (B, max_cand) int32, -1 padded."""
    if dedup_impl == "packed":
        raise NotImplementedError(
            "serve.dedup_impl='packed' is not ported: ROADMAP Queue 1 step 8 (packed dedup); "
            "'auto' is the exact form off the TPU, as in the JAX package"
        )
    if dedup_impl not in ("auto", "exact"):
        raise ValueError(f"unknown serve.dedup_impl {dedup_impl!r}")
    if candidate_ranking == "approx_maxsim":
        token_ids = torch.arange(q_view, device=pids.device).repeat_interleave(depth)
        cand, _ = dedup_pids_by_approx_maxsim(pids, token_ids, scores, q_view, max_cand)
    else:
        cand, _ = dedup_pids_by_score(pids, scores, max_cand)
    return cand


def rerank_fp32(cand: torch.Tensor, Qm: torch.Tensor, table: torch.Tensor, *, dv: int) -> torch.Tensor:
    """Exact fp32 MaxSim (B, C) of each candidate over an fp32 table, -inf
    where ``cand < 0``: the JAX searcher's XLA branch for a uniform corpus
    (``colbert_tpu/ranking/searcher.py:310-328``, ``maxsim_qd``) in torch
    ops -- gather the candidates' blocks, einsum, max over rows, sum over
    views -- in its chunks (8 queries, candidate slices halved while a
    chunk's gather would pass 2^30 two-byte values), with TF32 off."""
    B, C = cand.shape
    dim = table.shape[1]
    docs = table[: (table.shape[0] // dv) * dv].view(-1, dv, dim)
    qc = _FP32_QUERY_CHUNK
    cc = C
    while qc * cc * dv * dim * 2 > (1 << 30) and cc > 256:
        cc //= 2
    if C % cc:
        cc = C
    out = torch.empty((B, C), dtype=torch.float32, device=Qm.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for q0 in range(0, B, qc):
            q = Qm[q0 : q0 + qc].float()
            for c0 in range(0, C, cc):
                c = cand[q0 : q0 + qc, c0 : c0 + cc].long()
                sim = torch.einsum("bqh,bcdh->bcqd", q, docs[c.clamp(min=0)])
                out[q0 : q0 + qc, c0 : c0 + cc] = sim.amax(dim=-1).sum(dim=-1).masked_fill(c < 0, float("-inf"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def rerank(cand: torch.Tensor, Qm: torch.Tensor, table: torch.Tensor,
           inv_scale: Optional[torch.Tensor], *, dv: int) -> torch.Tensor:
    """Exact MaxSim (B, C) of each candidate, by the table's dtype: K5 over
    int8 (the descale folded into the fp32 queries), K4 over bf16,
    :func:`rerank_fp32` over fp32."""
    if table.dtype == torch.int8:
        return maxsim_rerank_uniform_int8(cand, Qm.float() * inv_scale, table, dv=dv)
    if table.dtype == torch.float32:
        return rerank_fp32(cand, Qm, table, dv=dv)
    return maxsim_rerank_uniform(cand, Qm, table, dv=dv)


def retrieval_core(Qm: torch.Tensor, qm: torch.Tensor, probe_fn: ProbeFn, pid_by_row: torch.Tensor,
                   table: torch.Tensor, inv_scale: Optional[torch.Tensor], *, dv: int, depth: int,
                   max_cand: int, topk: int, candidate_ranking: str = "approx_maxsim",
                   dedup_impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Everything after query encode (``colbert_tpu/ranking/searcher.py:126``)
    for a uniform-doclen corpus: probe -> dedup -> rerank -> top-k.
    Returns (scores (B, k) fp32, pids (B, k) int32), k = min(topk, max_cand)."""
    pids, scores = probe_pids(Qm, qm, probe_fn, pid_by_row)
    cand = dedup(pids, scores, q_view=Qm.shape[1], depth=depth, max_cand=max_cand,
                 candidate_ranking=candidate_ranking, dedup_impl=dedup_impl)
    return select_topk(rerank(cand, Qm, table, inv_scale, dv=dv), cand, min(topk, max_cand))


class ColbertSearcher:
    def __init__(
        self,
        cfg: ColbertConfig,
        tokenizer: ColbertTokenizer,
        model: ColbertModel,
        storage: IndexStorage,
        device: str | torch.device = "cuda",
    ):
        if cfg.serve.mode not in ("flat", "ann"):
            raise ValueError(f"unknown serve.mode {cfg.serve.mode!r}")
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
        self.flat_dv = None
        dv = (
            _meta_d_view(meta, cfg)
            if meta.get("multiview", True)
            else (int(doclens.max()) if len(doclens) else 1)
        )
        if cfg.serve.mode == "ann":
            self._init_ann(storage, meta, doclens, dv)
            return
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

    def _init_ann(self, storage: IndexStorage, meta: dict, doclens: np.ndarray, dv: int) -> None:
        """Device-resident IVF state and the rerank table
        (``colbert_tpu/ranking/searcher.py:428-476, 551-571``)."""
        s = self.cfg.serve
        dev = self.device
        ivf = storage.read_ivf()
        self.codec = meta.get("codec", "pq" if "codebooks" in ivf else "sq")
        as_dev = lambda name, dtype: torch.from_numpy(np.ascontiguousarray(ivf[name], dtype)).to(dev)
        self.coarse = as_dev("coarse_centroids", np.float32)
        if self.codec in ("pq", "pq4"):
            self.quant = as_dev("codebooks", np.float32)
        else:
            self.quant = (as_dev("sq_proj", np.float32), as_dev("sq_scales", np.float32))
        # pq codes are uint8 sub-quantizer ids; pq4 packs two nibbles per int8, sq is int8
        self.codes = as_dev("codes", np.uint8 if self.codec == "pq" else np.int8)
        self.offsets = as_dev("offsets", np.int32)
        lens = np.diff(np.asarray(ivf["offsets"]))
        self.max_list_len = int(lens.max()) if lens.size else 1
        # fused CSR-row -> pid map (one gather on the hot path instead of two)
        self.pid_by_row = torch.from_numpy(
            np.asarray(ivf["emb2pid"], np.int32)[np.asarray(ivf["row_emb"], np.int64)]
        ).to(dev)
        self.rerank_cap = dv
        self.probe_fn()  # refuses an unknown codec or probe before the tables are built
        if not (len(doclens) and (doclens == dv).all()):
            raise NotImplementedError(
                "ANN serving of a ragged corpus (the stride-bucket rerank) is not ported: "
                "ROADMAP Queue 1 step 8 (ragged stride-bucket rerank)"
            )
        emb = storage.load_all_embeddings()[: self.num_docs * self.rerank_cap]
        if s.rerank_dtype == "int8":
            q8, scale = quantize_emb_table(emb)
            self.emb_table = torch.from_numpy(q8).to(dev)
            self.emb_inv_scale = torch.from_numpy((1.0 / scale).astype(np.float32)).to(dev)
        else:
            tdt = torch.float32 if s.rerank_dtype == "float32" else torch.bfloat16
            self.emb_table = torch.from_numpy(np.ascontiguousarray(emb)).to(dev).to(tdt)
            self.emb_inv_scale = None

    # ---- device pipeline ----

    @torch.inference_mode()
    def encode_queries(self, q_ids, q_attn, q_active) -> torch.Tensor:
        """Masked query reps ``(B, q_view, dim)`` fp32; descaled for an int8
        flat table (the ANN path descales inside :func:`rerank`)."""
        dev = self.device
        Q = self.model.query(torch.as_tensor(q_ids).to(dev), torch.as_tensor(q_attn).to(dev))
        Qm = Q * torch.as_tensor(q_active).to(dev, Q.dtype)[..., None]
        if self.flat_dv is not None and self.emb_inv_scale is not None:
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

    def probe_fn(self, nprobe: Optional[int] = None, depth: Optional[int] = None) -> ProbeFn:
        s = self.cfg.serve
        nprobe = min(nprobe or s.nprobe, int(self.coarse.shape[0]))
        return make_probe_fn(
            self.codec, self.coarse, self.quant, self.codes, self.offsets, nprobe=nprobe,
            cap=self.max_list_len, depth=depth or s.candidate_depth, probe_impl=s.probe_impl,
            list_topr=s.probe_list_topr, hot_cap=s.probe_hot_lists or max(64, nprobe),
        )

    @torch.inference_mode()
    def search_reps(self, Qm: torch.Tensor, qm: torch.Tensor, topk: Optional[int] = None,
                    nprobe: Optional[int] = None, depth: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ANN search from masked query reps ``Qm`` (B, qv, dim) and their
        active mask ``qm`` (B, qv) on the device -> (scores, pids) tensors."""
        s = self.cfg.serve
        depth = depth or s.candidate_depth
        return retrieval_core(
            Qm, qm, self.probe_fn(nprobe, depth), self.pid_by_row, self.emb_table,
            self.emb_inv_scale, dv=self.rerank_cap, depth=depth,
            max_cand=min(s.max_candidates, self.num_docs), topk=topk or s.topk,
            candidate_ranking=s.candidate_ranking, dedup_impl=s.dedup_impl,
        )

    def _search(self, q_ids, q_attn, q_active, topk: int, nprobe: Optional[int],
                depth: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.flat_dv is not None:
            return self._search_flat(q_ids, q_attn, q_active, topk)
        Qm = self.encode_queries(q_ids, q_attn, q_active)
        qm = torch.as_tensor(q_active).to(self.device, torch.float32)
        return self.search_reps(Qm, qm, topk, nprobe, depth)

    # ---- public API ----

    def search(self, questions: Sequence[str], topk: Optional[int] = None,
               nprobe: Optional[int] = None, depth: Optional[int] = None) -> SearchResult:
        enc = self.tok.encode_queries(list(questions))
        return self.search_tokens(enc.input_ids, enc.attention_mask, enc.active_mask,
                                  topk=topk, nprobe=nprobe, depth=depth)

    def search_tokens(self, q_ids, q_attn, q_active, topk: Optional[int] = None,
                      nprobe: Optional[int] = None, depth: Optional[int] = None) -> SearchResult:
        """Search from pre-tokenized queries; ``nprobe``/``depth`` are ANN
        knobs that flat mode ignores, as the JAX searcher does."""
        with self.timers.span("search"):
            ts, tp = self.search_tokens_device(q_ids, q_attn, q_active, topk=topk,
                                               nprobe=nprobe, depth=depth)
        return SearchResult(tp, ts)

    def search_tokens_device(self, q_ids, q_attn, q_active, topk: Optional[int] = None,
                             nprobe: Optional[int] = None, depth: Optional[int] = None
                             ) -> PendingResult:
        """Dispatch a batch and return a handle that synchronises only when
        unpacked: submitting the next batch before fetching this one overlaps
        host work with the device."""
        ts, tp = self._search(q_ids, q_attn, q_active, topk or self.cfg.serve.topk, nprobe, depth)
        return PendingResult(ts, tp)

    @torch.inference_mode()
    def exact_topk(self, Qm: torch.Tensor, topk: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 MaxSim of masked query reps ``Qm`` (not descaled) against
        every doc of the served table (int8 dequantized) -> top-k (scores,
        pids): the recall oracle."""
        dv = self.flat_dv or self.rerank_cap
        table = self.emb_table[: self.num_docs * dv]
        q = Qm.float()
        scores = torch.empty((q.shape[0], self.num_docs), dtype=torch.float32, device=q.device)
        for lo in range(0, self.num_docs, _ORACLE_DOCS):
            D = table[lo * dv : (lo + _ORACLE_DOCS) * dv].float()
            if self.emb_inv_scale is not None:
                D = D * self.emb_inv_scale
            sim = torch.einsum("bqh,ndh->bnqd", q, D.view(-1, dv, D.shape[-1]))
            scores[:, lo : lo + _ORACLE_DOCS] = sim.amax(dim=-1).sum(dim=-1)
        return torch.topk(scores, min(topk, self.num_docs), dim=1)

    def search_brute_force(self, questions: Sequence[str], topk: int) -> SearchResult:
        """Exact fp32 MaxSim over the whole corpus (no ANN): the recall oracle
        (``colbert_tpu/ranking/searcher.py:880``)."""
        enc = self.tok.encode_queries(list(questions))
        with torch.inference_mode():
            dev = self.device
            Q = self.model.query(torch.as_tensor(enc.input_ids).to(dev),
                                 torch.as_tensor(enc.attention_mask).to(dev))
            Qm = Q * torch.as_tensor(enc.active_mask).to(dev, Q.dtype)[..., None]
        ts, tp = self.exact_topk(Qm, topk)
        return SearchResult(tp.int().cpu().numpy(), ts.cpu().numpy())
