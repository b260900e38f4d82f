"""Searcher: counterpart of ``colbert_tpu/ranking/searcher.py``.

Two serving modes, as ``serve.mode`` selects:

* flat (``:361-426, 575-619``): query tokens -> BERT + ColBERT head ->
  mask (+ int8 descale) -> flat scan kernel (K1/K2) -> exact top-k, over a
  doc-major table built from the encoded parts;
* ann (``:89-357, 428-571``): query tokens -> BERT + ColBERT head -> the
  codec's IVF probe (sq: K6 slots and K7 hot lists, or K10 per token with
  ``serve.probe_impl="token"``; pq4: K8; pq: an fp32 LUT gather in torch
  ops) -> CSR row -> pid -> dedup (exact; ``serve.dedup_impl="packed"``:
  one int32 key a slot) -> exact MaxSim rerank -> top-k, over the IVF
  index that ``build-index`` writes.  ``serve.rerank_dtype`` picks the
  rerank table: "bfloat16" (K4, the fused gather + MaxSim kernel), "int8"
  (K5) or "float32": an fp32 table reranked by a gather and an fp32 einsum
  in torch ops (:func:`rerank_fp32`), as the JAX package reranks an fp32
  table off the TPU (its XLA branch, ``:310-328``).  A ragged corpus
  (multiview off) keeps its bf16 or int8 table as stride buckets, K4 or K5
  launched once a bucket (``:257-285, 505-550``), and its fp32 table
  ragged, gathered over ``doc_offsets`` with a doclen mask.
  ``serve.rerank_table="host"`` keeps an int8 table in host memory: the
  dedup's first ``host_rerank_candidates`` candidates are gathered on the
  host, copied to the card and reranked by K5 (``:477-504, 736-878``).

The index and the device tables are built once and held on the device.
The JAX package's ``serve.rerank_kernel`` gate (Pallas kernel or XLA
gather) is a TPU-side choice and changes nothing here.  Flat mode serves
"float32" from a bf16 table, as the JAX flat path does.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from colbert_tpu_torch.config import ColbertConfig
from colbert_tpu_torch.utils.logging import Timers
from colbert_tpu_torch.indexing.storage import IndexStorage
from colbert_tpu_torch.models.colbert import ColbertModel
from colbert_tpu_torch.models.sharding import place
from colbert_tpu_torch.ops.flat_scan import (
    build_flat_table, flat_maxsim_scan, flat_scan_topk, flat_topk,
)
from colbert_tpu_torch.ops.ivf import (
    dedup_pids_by_approx_maxsim, dedup_pids_by_approx_maxsim_packed, dedup_pids_by_score, ivf_probe_adc,
    ivf_probe_sq, ivf_probe_sq_batched,
)
from colbert_tpu_torch.ops.pq4 import ivf_probe_pq4
from colbert_tpu_torch.ops.rerank import (
    BucketTables, build_ragged_buckets, check_int8_table_dim, maxsim_rerank_buckets, maxsim_rerank_uniform,
    maxsim_rerank_uniform_int8, quantize_emb_into, stride_buckets,
)
from colbert_tpu_torch.parallel.mesh import device_mesh
from colbert_tpu_torch.tokenization import ColbertTokenizer

ProbeFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
_ORACLE_DOCS = 4096  # docs per step of the exact oracle
_ORACLE_SIMS = 1 << 28  # fp32 similarities per step of the exact oracle
_FP32_QUERY_CHUNK = 8  # queries per step of the fp32 rerank (the JAX searcher's query_chunk)
_HOST_BLOCK_BYTES = 4 << 30  # int8 doc blocks a host-table gather moves to the card at once


class RaggedTable(NamedTuple):
    """A ragged corpus's fp32 rerank table on the device: doc ``p``'s rows
    are ``rows[doc_offsets[p] : doc_offsets[p] + doclens[p]]``."""
    rows: torch.Tensor         # (N, dim) fp32
    doc_offsets: torch.Tensor  # (num_docs,) int64
    doclens: torch.Tensor      # (num_docs,) int64


class HostTable(NamedTuple):
    """``serve.rerank_table="host"``: the int8 rerank table in host memory
    (pinned when the searcher serves a card), doc-major for a uniform corpus,
    CSR for a ragged one."""
    rows: torch.Tensor                 # (num_docs, cap * dim) uniform, or (N, dim) ragged; int8, CPU
    doc_offsets: Optional[torch.Tensor]  # (num_docs,) int64 first row of each doc; None uniform
    doclens: torch.Tensor              # (num_docs,) int64
    cap: int                           # rows a gathered block: d_view, or the longest doc

    def gather(self, cand: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """The blocks of ``cand`` (n, hc) int64 (-1: doc 0's) into ``out``
        (n * hc * cap, dim) int8: ``cap`` rows from each doc's first row
        (for a ragged doc, rows past its end are the next docs' rows)."""
        safe = cand.clamp(min=0).reshape(-1)
        if self.doc_offsets is None:
            return torch.index_select(self.rows, 0, safe, out=out.view(-1, self.rows.shape[1])).view(out.shape)
        idx = self.doc_offsets[safe][:, None] + torch.arange(self.cap)
        return torch.index_select(self.rows, 0, idx.clamp(max=self.rows.shape[0] - 1).view(-1), out=out)


class _Docs(NamedTuple):
    """What the exact oracle scores: doc ``p`` is ``cap`` rows of ``rows``
    from ``offsets[p]`` (``p * cap`` where ``offsets`` is None), rows past
    ``doclens[p]`` zeroed, times ``inv`` (int8 tables)."""
    rows: torch.Tensor
    cap: int
    offsets: Optional[torch.Tensor] = None
    doclens: Optional[torch.Tensor] = None
    inv: Optional[torch.Tensor] = None


@dataclass
class SearchResult:
    pids: np.ndarray    # (B, topk) int32, -1 padded
    scores: np.ndarray  # (B, topk) fp32


class PendingResult:
    """Device tensors (a batch's ``(scores, pids)``) copied to pinned host
    memory without waiting; iterating it waits for that copy only and yields
    numpy arrays (the async serving path of
    :meth:`ColbertSearcher.search_tokens_device`)."""

    def __init__(self, *tensors: torch.Tensor):
        self._event = None
        self._host = list(tensors)
        if tensors[0].is_cuda:
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def __iter__(self):
        if self._event is not None:
            self._event.synchronize()
        return iter([h.numpy() for h in self._host])


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
    """The codec's candidate generator for :meth:`ColbertSearcher.candidates`
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
          candidate_ranking: str = "approx_maxsim", dedup_impl: str = "auto",
          num_docs: Optional[int] = None) -> torch.Tensor:
    """Each query's ``max_cand`` candidate pids (B, max_cand) int32, -1
    padded, best first.  ``dedup_impl="packed"`` (approx-MaxSim ranking
    only) packs each slot into one int32 and needs ``num_docs``; "auto" is
    the exact form, as in the JAX package off the TPU."""
    if dedup_impl not in ("auto", "exact", "packed"):
        raise ValueError(f"unknown serve.dedup_impl {dedup_impl!r}")
    if candidate_ranking == "approx_maxsim":
        token_ids = torch.arange(q_view, device=pids.device).repeat_interleave(depth)
        if dedup_impl == "packed":
            if num_docs is None:
                raise ValueError("the packed dedup needs num_docs")
            cand, _ = dedup_pids_by_approx_maxsim_packed(pids, token_ids, scores, q_view, max_cand, num_docs)
        else:
            cand, _ = dedup_pids_by_approx_maxsim(pids, token_ids, scores, q_view, max_cand)
    else:
        cand, _ = dedup_pids_by_score(pids, scores, max_cand)
    return cand


def rerank_fp32(cand: torch.Tensor, Qm: torch.Tensor, table: torch.Tensor, *, dv: int,
                ragged: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Exact fp32 MaxSim (B, C) of each candidate over an fp32 table, -inf
    where ``cand < 0``: the JAX searcher's XLA branch
    (``colbert_tpu/ranking/searcher.py:310-328``, ``maxsim_qd``) in torch
    ops -- gather the candidates' blocks, einsum, max over rows, sum over
    views -- in its chunks (8 queries, candidate slices halved while a
    chunk's gather would pass 2^30 two-byte values), with TF32 off.
    Uniform: doc ``p`` is rows ``[p*dv, (p+1)*dv)``.  ``ragged`` =
    ``(doc_offsets, doclens)``: ``dv`` rows from each doc's offset (clipped
    to the table), those past its doclen zeroed, as JAX's doclen mask."""
    B, C = cand.shape
    dim = table.shape[1]
    docs = table[: (table.shape[0] // dv) * dv].view(-1, dv, dim)
    rows = torch.arange(dv, device=table.device)
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
                safe = c.clamp(min=0)
                if ragged is None:
                    D = docs[safe]
                else:
                    idx = (ragged[0][safe][..., None] + rows).clamp(max=table.shape[0] - 1)
                    D = table[idx].masked_fill_((rows >= ragged[1][safe][..., None])[..., None], 0.0)
                sim = torch.einsum("bqh,bcdh->bcqd", q, D)
                out[q0 : q0 + qc, c0 : c0 + cc] = sim.amax(dim=-1).sum(dim=-1).masked_fill(c < 0, float("-inf"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def rerank(cand: torch.Tensor, Qm: torch.Tensor, table, inv_scale: Optional[torch.Tensor], *, dv: int
           ) -> torch.Tensor:
    """Exact MaxSim (B, C) of each candidate, by the table: K4 or K5 a
    stride bucket (:class:`BucketTables`), the ragged fp32 gather
    (:class:`RaggedTable`), or by a uniform table's dtype: K5 over int8 (the
    descale folded into the fp32 queries), K4 over bf16,
    :func:`rerank_fp32` over fp32."""
    if isinstance(table, BucketTables):
        return maxsim_rerank_buckets(cand, Qm, *table, inv_scale=inv_scale)
    if isinstance(table, RaggedTable):
        return rerank_fp32(cand, Qm, table.rows, dv=dv, ragged=(table.doc_offsets, table.doclens))
    if table.dtype == torch.int8:
        return maxsim_rerank_uniform_int8(cand, Qm.float() * inv_scale, table, dv=dv)
    if table.dtype == torch.float32:
        return rerank_fp32(cand, Qm, table, dv=dv)
    return maxsim_rerank_uniform(cand, Qm, table, dv=dv)


def host_rerank(cand: torch.Tensor, Qm: torch.Tensor, host: HostTable, inv_scale: torch.Tensor, topk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The host table's rerank (``colbert_tpu/ranking/searcher.py:736-805``):
    each query's funnel ``cand`` (B, hc) on the host, sorted by pid (-1
    first, as JAX's stable argsort), its docs' blocks gathered on the host
    into pinned memory, copied to ``Qm``'s device without waiting, and
    scored by K5 as a compact doc-major table (``cand[b, c] -> b*hc + c``)
    against ``bf16(Qm * inv_scale)``, the JAX package's query operand (its
    three-term split is then exact).  A ragged doc's rows past its doclen
    are zeroed on the device first, as JAX masks them.  Queries go in chunks
    of at most ``_HOST_BLOCK_BYTES`` of blocks, one K5 launch each.  Returns
    (scores (B, k), pids (B, k)) on the device, k = min(topk, hc)."""
    dev = Qm.device
    cand = torch.sort(cand.long(), dim=1).values
    B, hc = cand.shape
    cap, dim = host.cap, Qm.shape[-1]
    q = (Qm.float() * inv_scale).to(torch.bfloat16).float()
    cand_dev = cand.to(dev, non_blocking=True)
    scores = torch.empty((B, hc), dtype=torch.float32, device=dev)
    nq = max(1, min(B, _HOST_BLOCK_BYTES // max(1, hc * cap * dim)))
    rows = torch.arange(cap, device=dev)
    for q0 in range(0, B, nq):
        c = cand[q0 : q0 + nq]
        n = c.shape[0]
        buf = torch.empty((n * hc * cap, dim), dtype=torch.int8, pin_memory=dev.type == "cuda")
        blocks = host.gather(c, buf).to(dev, non_blocking=True)
        cd = cand_dev[q0 : q0 + nq]
        if host.doc_offsets is not None:
            dl = host.doclens[c.clamp(min=0)].to(dev, non_blocking=True)
            blocks.view(n, hc, cap, dim).masked_fill_((rows >= dl[..., None])[..., None], 0)
        local = torch.arange(n * hc, dtype=torch.int32, device=dev).view(n, hc)
        scores[q0 : q0 + nq] = maxsim_rerank_uniform_int8(torch.where(cd >= 0, local, -1), q[q0 : q0 + nq],
                                                          blocks, dv=cap)
    return select_topk(scores, cand_dev.int(), min(topk, hc))


class _FutureResult:
    """``(scores, pids)`` numpy arrays of a batch whose host-table rerank runs
    on the searcher's worker thread; iterating it waits for that thread."""

    def __init__(self, future):
        self._future = future

    def __iter__(self):
        return iter(self._future.result())


class ColbertSearcher:
    def __init__(
        self,
        cfg: ColbertConfig,
        tokenizer: ColbertTokenizer,
        model: ColbertModel,
        storage: IndexStorage,
        device: str | torch.device = "cuda",
    ):
        """The queries are encoded by ``device`` at ``mesh.model`` positions
        (``parallel/mesh.py::device_mesh``); the index lives on the first."""
        if cfg.serve.mode not in ("flat", "ann"):
            raise ValueError(f"unknown serve.mode {cfg.serve.mode!r}")
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
        self.timers = Timers()
        self.host_table: Optional[HostTable] = None
        self.ragged_strides: Optional[Tuple[int, ...]] = None
        self._host_executor: Optional[ThreadPoolExecutor] = None  # the host table's worker, made on first use
        self._executor_lock = threading.Lock()
        self._host_lock = threading.Lock()  # one host gather at a time: they share the host's memory bandwidth

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
        self._oracle = _Docs(self.emb_table, dv, inv=self.emb_inv_scale)
        self.score_dtype = cfg.serve.flat_score_dtype
        if self.score_dtype == "auto":
            # fp32 scores up to 256k docs (tie-exact at negligible memory);
            # bf16 above (halves the score matrix)
            self.score_dtype = "float32" if self.num_docs <= (1 << 18) else "bfloat16"

    def _init_ann(self, storage: IndexStorage, meta: dict, doclens: np.ndarray, dv: int) -> None:
        """Device-resident IVF state and the rerank table
        (``colbert_tpu/ranking/searcher.py:428-571``): a uniform corpus's
        doc-major table; a ragged corpus's stride buckets (bf16, int8) or
        ragged fp32 table; or the int8 host table."""
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
        self.uniform_doclen = bool(len(doclens) and (doclens == dv).all())
        self.probe_fn()  # refuses an unknown codec or probe before the tables are built
        host = s.rerank_table == "host"
        emb = storage.load_all_embeddings()
        self.emb_inv_scale = None
        if self.uniform_doclen:
            emb = emb[: self.num_docs * dv]
            offsets = None
        else:
            offsets = torch.from_numpy(IndexStorage.doc_offsets_from_doclens(doclens.tolist())[:-1])
        lens_t = torch.from_numpy(doclens.astype(np.int64))

        def int8_rows(out: torch.Tensor) -> torch.Tensor:
            """``emb`` quantized into ``out`` on the searcher's device; sets the descale."""
            scale = quantize_emb_into(emb, out, device=dev)
            self.emb_inv_scale = torch.ones_like(scale) / scale
            return out

        if host:
            # the reference's placement (host RAM, colbert_ranker.py:61-73): int8, doc-major or CSR
            rows = int8_rows(torch.empty(emb.shape, dtype=torch.int8, pin_memory=dev.type == "cuda"))
            if offsets is None:
                rows = rows.view(self.num_docs, -1)
            self.host_table = HostTable(rows, offsets, lens_t, dv)
            self.emb_table = None
            self._oracle = _Docs(self.host_table.rows.view(-1, self.dim), dv, offsets, lens_t, self.emb_inv_scale)
            return
        if self.uniform_doclen:
            if s.rerank_dtype == "int8":
                check_int8_table_dim(self.dim)
                self.emb_table = int8_rows(torch.empty(emb.shape, dtype=torch.int8, device=dev))
            else:
                tdt = torch.float32 if s.rerank_dtype == "float32" else torch.bfloat16
                self.emb_table = torch.from_numpy(np.ascontiguousarray(emb)).to(dev).to(tdt)
            self._oracle = _Docs(self.emb_table, dv, inv=self.emb_inv_scale)
            return
        if s.rerank_dtype == "float32":
            # the JAX searcher's XLA branch over a ragged fp32 table
            self.emb_table = RaggedTable(torch.from_numpy(emb).to(dev).float(), offsets.to(dev), lens_t.to(dev))
            self._oracle = _Docs(self.emb_table.rows, dv, self.emb_table.doc_offsets, self.emb_table.doclens)
            return
        # stride buckets (JAX :505-550): zero-padded per-stride tables, K4/K5 a bucket
        if s.rerank_dtype == "int8":
            # JAX's row rule for its lane-packed int8 buckets, so the strides are its strides
            strides = stride_buckets(doclens, row_multiple=16 if ((self.dim // 128) * 16) % 32 == 0 else 32)
            raw, b_of, s_of = build_ragged_buckets(int8_rows(torch.empty(emb.shape, dtype=torch.int8)).numpy(),
                                                   doclens, strides)
            tables = tuple(torch.from_numpy(t).to(dev) for t in raw)
        else:
            strides = stride_buckets(doclens, row_multiple=16)
            raw, b_of, s_of = build_ragged_buckets(emb, doclens, strides)
            tables = tuple(torch.from_numpy(t).to(dev).to(torch.bfloat16) for t in raw)
        self.ragged_strides = tuple(int(x) for x in strides)
        self.emb_table = BucketTables(tables, self.ragged_strides, torch.from_numpy(b_of).to(dev),
                                      torch.from_numpy(s_of).to(dev))
        # the oracle scores the stored embeddings, as the JAX searcher's host copy
        self._oracle = _Docs(torch.from_numpy(emb), dv, offsets, lens_t)

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
    def candidates(self, Qm: torch.Tensor, qm: torch.Tensor, nprobe: Optional[int] = None,
                   depth: Optional[int] = None) -> torch.Tensor:
        """Probe and dedup: each query's ``min(max_candidates, num_docs)``
        candidate pids (B, max_cand) int32, -1 padded, best first."""
        s = self.cfg.serve
        depth = depth or s.candidate_depth
        pids, scores = probe_pids(Qm, qm, self.probe_fn(nprobe, depth), self.pid_by_row)
        return dedup(pids, scores, q_view=Qm.shape[1], depth=depth, max_cand=min(s.max_candidates, self.num_docs),
                     candidate_ranking=s.candidate_ranking, dedup_impl=s.dedup_impl, num_docs=self.num_docs)

    def host_funnel(self, topk: int) -> int:
        """Candidates a query the host table reranks (``searcher.py:816``)."""
        s = self.cfg.serve
        return max(topk, min(s.host_rerank_candidates, s.max_candidates, self.num_docs))

    @torch.inference_mode()
    def _host_finish(self, cand: torch.Tensor, Qm: torch.Tensor, topk: int) -> Tuple[torch.Tensor, torch.Tensor]:
        with self._host_lock:
            return host_rerank(cand, Qm, self.host_table, self.emb_inv_scale, topk)

    @torch.inference_mode()
    def search_reps(self, Qm: torch.Tensor, qm: torch.Tensor, topk: Optional[int] = None,
                    nprobe: Optional[int] = None, depth: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ANN search from masked query reps ``Qm`` (B, qv, dim) and their
        active mask ``qm`` (B, qv) on the device -> (scores, pids) tensors:
        probe -> dedup -> exact rerank (:func:`rerank`, or the host table's
        :func:`host_rerank`) -> top-k (``colbert_tpu/ranking/searcher.py:126``)."""
        topk = topk or self.cfg.serve.topk
        cand = self.candidates(Qm, qm, nprobe, depth)
        if self.host_table is not None:
            return self._host_finish(cand[:, : self.host_funnel(topk)].cpu(), Qm, topk)
        scores = rerank(cand, Qm, self.emb_table, self.emb_inv_scale, dv=self.rerank_cap)
        return select_topk(scores, cand, min(topk, cand.shape[1]))

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
                             nprobe: Optional[int] = None, depth: Optional[int] = None):
        """Dispatch a batch and return a handle that synchronises only when
        unpacked into ``(scores, pids)`` numpy arrays: submitting the next
        batch before fetching this one overlaps host work with the device.
        With the host table, this batch's probe and dedup are issued here and
        its host gather and rerank run on one worker thread
        (``searcher.py:823-863``), so they overlap the next batch's probe."""
        topk = topk or self.cfg.serve.topk
        if self.host_table is None:
            return PendingResult(*self._search(q_ids, q_attn, q_active, topk, nprobe, depth))
        with torch.inference_mode():
            Qm = self.encode_queries(q_ids, q_attn, q_active)
            qm = torch.as_tensor(q_active).to(self.device, torch.float32)
            cand = PendingResult(self.candidates(Qm, qm, nprobe, depth)[:, : self.host_funnel(topk)])
        with self._executor_lock:
            if self._host_executor is None:
                self._host_executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="host-rerank")
            executor = self._host_executor

        def finish():
            (c,) = cand
            return tuple(PendingResult(*self._host_finish(torch.from_numpy(c), Qm, topk)))

        return _FutureResult(executor.submit(finish))

    def close(self) -> None:
        """Shut the host table's worker thread down (waiting for its batches);
        a later search starts a new one."""
        with self._executor_lock:
            executor, self._host_executor = self._host_executor, None
        if executor is not None:
            executor.shutdown(wait=True)

    @torch.inference_mode()
    def _oracle_docs(self, lo: int, hi: int) -> torch.Tensor:
        """Docs ``[lo, hi)`` as the oracle scores them: (n, cap, dim) fp32 on
        the device, rows past a ragged doc's doclen zeroed, int8 descaled."""
        o = self._oracle
        n, dim = hi - lo, o.rows.shape[1]
        if o.offsets is None:
            D = o.rows[lo * o.cap : hi * o.cap].to(self.device).view(n, o.cap, dim).float()
        else:
            r = torch.arange(o.cap, device=o.rows.device)
            idx = (o.offsets[lo:hi, None].to(o.rows.device) + r).clamp(max=o.rows.shape[0] - 1)
            D = o.rows[idx].to(self.device).float()
            past = r.to(self.device) >= o.doclens[lo:hi, None].to(self.device)
            D.masked_fill_(past[..., None], 0.0)
        return D * o.inv if o.inv is not None else D

    @torch.inference_mode()
    def exact_topk(self, Qm: torch.Tensor, topk: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 MaxSim of masked query reps ``Qm`` (not descaled) against
        every doc -> top-k (scores, pids): the recall oracle.  It scores the
        served table (int8 dequantized; the host table on the host), except
        over stride buckets, where it scores the stored embeddings, as the
        JAX searcher does; a ragged doc is the longest doc's count of rows
        from its first, those past its doclen zeroed
        (``colbert_tpu/ranking/searcher.py:904-947``)."""
        q = Qm.float()
        B, qv = q.shape[:2]
        step = max(1, min(_ORACLE_DOCS, _ORACLE_SIMS // max(1, B * qv * self._oracle.cap)))
        scores = torch.empty((B, self.num_docs), dtype=torch.float32, device=q.device)
        for lo in range(0, self.num_docs, step):
            hi = min(lo + step, self.num_docs)
            sim = torch.einsum("bqh,ndh->bnqd", q, self._oracle_docs(lo, hi))
            scores[:, lo:hi] = sim.amax(dim=-1).sum(dim=-1)
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
