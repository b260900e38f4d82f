"""Corpus-sharded search: counterpart of ``colbert_tpu/ranking/sharded.py``.

One process drives every shard, as the JAX ``shard_map`` does: each
position of the mesh's ``data`` axis (``parallel/mesh.py::make_mesh``) owns
a contiguous pid range of the corpus on its device, the full query batch
runs the shard's whole pipeline there, and the shards' top-k (ids made
global by the shard's ``pid_base``) merge into the global top-k
(``ops/topk.py::topk_merge_gathered``, the JAX merge's tie rule).

* flat (``:201-300``): a shard's doc-major table, the K2 scan
  (``flat_maxsim_scan``), its pad docs at -inf, its top-k;
* ann (``:99-200, 304-375``): :func:`shard_index` re-partitions the global
  IVF index (shared coarse centroids and quantizer, each shard's own CSR
  lists); a shard runs the probe (sq: K6/K7, or K10 with
  ``serve.probe_impl="token"``; pq: the fp32 LUT gather), the dedup and
  the rerank (K4 over bf16, K5 over int8, ``rerank_fp32`` over fp32; a
  ragged corpus's stride buckets or fp32 gather) of ``ranking/searcher.py``.

An int8 table (flat or ann) is quantized with ONE per-dim scale over the
whole corpus, so that scores compare across shards.  The pq4 codec is
refused, with the JAX package's reason, and so are the host table and a
ragged int8 table (the JAX sharded searcher has neither).  Queries are
encoded by the first data position's model group (sharded over it at
``mesh.model > 1``, as the JAX searcher's parameters are) and copied to each
shard's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from colbert_tpu_torch.config import ColbertConfig
from colbert_tpu_torch.indexing.storage import IndexStorage
from colbert_tpu_torch.models.colbert import ColbertModel
from colbert_tpu_torch.models.sharding import place
from colbert_tpu_torch.ops.flat_scan import _int8_scale, build_flat_table, flat_maxsim_scan, flat_topk
from colbert_tpu_torch.ops.ivf import sort_by_list
from colbert_tpu_torch.ops.rerank import (
    BucketTables, build_ragged_buckets, check_int8_table_dim, quantize_emb_into, stride_buckets,
)
from colbert_tpu_torch.ops.topk import pad_shard_topk, topk_merge_gathered
from colbert_tpu_torch.parallel.mesh import Mesh, local_shard_bounds, make_mesh
from colbert_tpu_torch.ranking.searcher import (
    PendingResult, RaggedTable, SearchResult, _meta_d_view, dedup, make_probe_fn, probe_pids, rerank,
    select_topk,
)
from colbert_tpu_torch.tokenization import ColbertTokenizer
from colbert_tpu_torch.utils.logging import Timers


def _pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad, constant_values=fill)


def shard_index(storage: IndexStorage, n_shards: int) -> Dict[str, np.ndarray]:
    """Split a globally built index into ``n_shards`` contiguous pid ranges
    (``colbert_tpu/ranking/sharded.py:46-97``): stacked arrays with a
    leading shard axis, each shard padded to the largest (codes, tables and
    maps by rows, -1 in the maps; doclens by docs), each shard's CSR lists
    re-sorted from its own rows, ``pid_base`` and ``num_docs`` a shard."""
    ivf = storage.read_ivf()
    doclens = np.asarray(storage.read_doclens(), np.int64)
    num_docs = len(doclens)
    emb2pid = ivf["emb2pid"]
    K = ivf["offsets"].shape[0] - 1
    # un-sort codes back to embedding order once, then re-sort per shard
    codes_by_emb = np.empty_like(ivf["codes"])
    codes_by_emb[ivf["row_emb"]] = ivf["codes"]
    assign_by_emb = np.repeat(np.arange(K, dtype=np.int32), ivf["offsets"][1:] - ivf["offsets"][:-1])
    assign_sorted = np.empty(emb2pid.shape[0], np.int32)
    assign_sorted[ivf["row_emb"]] = assign_by_emb

    emb_all = np.asarray(storage.load_all_embeddings())
    doc_off_all = IndexStorage.doc_offsets_from_doclens(doclens.tolist())

    shards: Dict[str, list] = {k: [] for k in (
        "codes", "row_emb", "offsets", "emb2pid", "pid_by_row", "emb_table",
        "doc_offsets", "doclens", "pid_base", "num_docs")}
    bounds = [local_shard_bounds(num_docs, s, n_shards) for s in range(n_shards)]
    max_docs = max(hi - lo for lo, hi in bounds)
    max_embs = max(int(doclens[lo:hi].sum()) for lo, hi in bounds)
    for lo, hi in bounds:
        e_lo, e_hi = int(doc_off_all[lo]), int(doc_off_all[hi])
        perm, offsets = sort_by_list(assign_sorted[e_lo:e_hi], K)
        shards["codes"].append(_pad_rows(codes_by_emb[e_lo:e_hi][perm], max_embs))
        shards["row_emb"].append(_pad_rows(perm.astype(np.int32), max_embs, fill=-1))
        shards["offsets"].append(offsets)
        e2p_local = (emb2pid[e_lo:e_hi] - lo).astype(np.int32)
        shards["emb2pid"].append(_pad_rows(e2p_local, max_embs, fill=-1))
        shards["pid_by_row"].append(_pad_rows(e2p_local[perm], max_embs, fill=-1))
        shards["emb_table"].append(_pad_rows(emb_all[e_lo:e_hi], max_embs))
        dl = _pad_rows(doclens[lo:hi].astype(np.int32), max_docs)
        shards["doclens"].append(dl)
        d_off = np.zeros(max_docs + 1, np.int32)
        np.cumsum(dl, out=d_off[1:])
        shards["doc_offsets"].append(d_off)
        shards["pid_base"].append(np.asarray([lo], np.int32))
        shards["num_docs"].append(np.asarray([hi - lo], np.int32))
    return {k: np.stack(v) for k, v in shards.items()}


class _Shard:
    """One shard's device-resident state."""

    def __init__(self, device: torch.device, pid_base: int, n_docs: int):
        self.device = device
        self.pid_base = pid_base
        self.n_docs = n_docs  # real docs (flat) or the padded count (ann: JAX's doclens.shape[0])
        self.table = None
        self.inv_scale: Optional[torch.Tensor] = None
        self.lists = None  # ann: (coarse, quantizer, codes, offsets) for make_probe_fn
        self.pid_by_row: Optional[torch.Tensor] = None


class ShardedColbertSearcher:
    """Same contract as :class:`ColbertSearcher` (``search``,
    ``search_tokens``, ``search_tokens_device``), the corpus sharded over
    ``mesh`` (default: ``make_mesh(cfg.mesh.data, cfg.mesh.model)``)."""

    def __init__(self, cfg: ColbertConfig, tokenizer: ColbertTokenizer, model: ColbertModel,
                 storage: IndexStorage, mesh: Optional[Mesh] = None):
        if cfg.serve.mode not in ("flat", "ann"):
            raise ValueError(f"unknown serve.mode {cfg.serve.mode!r}")
        if tokenizer.vocab_size > cfg.model.vocab_size:
            raise ValueError(
                f"tokenizer vocab ({tokenizer.vocab_size}) exceeds model.vocab_size ({cfg.model.vocab_size})"
            )
        self.cfg = cfg
        self.tok = tokenizer
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh.data, cfg.mesh.model)
        self.n_shards = self.mesh.data
        self.device = self.mesh.devices[0]
        self.model = place(model, self.mesh.grid[0]).eval()
        self.timers = Timers()
        meta = storage.read_meta()
        doclens = np.asarray(storage.read_doclens(), np.int64)
        self.num_docs = len(doclens)
        self.flat_dv = None
        dv = (_meta_d_view(meta, cfg) if meta.get("multiview", True)
              else (int(doclens.max()) if len(doclens) else 1))
        self.uniform_doclen = bool(len(doclens) and (doclens == dv).all())
        self.int8 = cfg.serve.rerank_dtype == "int8"
        if cfg.serve.mode == "flat":
            self.flat_dv = dv
            self.shards = self._init_flat(storage, doclens)
        else:
            self.rerank_cap = dv
            self.shards = self._init_ann(storage, meta, doclens)

    def _init_flat(self, storage: IndexStorage, doclens: np.ndarray) -> List[_Shard]:
        """Each shard's doc-major flat table (``sharded.py:201-260``)."""
        emb = storage.load_all_embeddings()
        scale = _int8_scale(emb, 1 << 18) if self.int8 else None
        doc_off = IndexStorage.doc_offsets_from_doclens(doclens.tolist())
        shards = []
        for s, dev in enumerate(self.mesh.devices):
            lo, hi = local_shard_bounds(self.num_docs, s, self.n_shards)
            e_lo, e_hi = int(doc_off[lo]), int(doc_off[hi])
            table, inv, _ = build_flat_table(emb[e_lo:e_hi], doclens[lo:hi], dv=self.flat_dv,
                                             dtype="int8" if self.int8 else "bfloat16", scale=scale)
            sh = _Shard(dev, lo, hi - lo)
            sh.table = table.to(dev)
            sh.inv_scale = inv.to(dev) if inv is not None else None
            shards.append(sh)
        return shards

    def _init_ann(self, storage: IndexStorage, meta: dict, doclens: np.ndarray) -> List[_Shard]:
        """Each shard's IVF lists and rerank table (``sharded.py:131-199``)."""
        s = self.cfg.serve
        ivf = storage.read_ivf()
        self.codec = meta.get("codec", "pq" if "codebooks" in ivf else "sq")
        if self.codec == "pq4":
            raise ValueError(
                "the pq4 codec's dense block scan is single-chip only (cost grows with corpus x tokens); "
                "use codec='sq' for sharded serving"
            )
        if s.rerank_table == "host":
            raise ValueError("serve.rerank_table='host' is single-device only; shard a device table instead")
        if self.int8 and not self.uniform_doclen:
            raise ValueError("rerank_dtype=int8 requires a uniform-doclen (multiview) corpus")
        if self.int8:
            check_int8_table_dim(int(meta["dim"]))
        sh = shard_index(storage, self.n_shards)
        S, max_embs, dim = sh["emb_table"].shape
        lens = sh["offsets"][:, 1:] - sh["offsets"][:, :-1]
        self.max_list_len = max(1, int(lens.max()))
        self.n_lists = int(ivf["coarse_centroids"].shape[0])
        int8_rows = inv = None
        if self.int8:
            # ONE per-dim scale over every shard: the merged scores compare
            int8_rows = torch.empty((S * max_embs, dim), dtype=torch.int8)
            scale = quantize_emb_into(sh["emb_table"].reshape(S * max_embs, dim), int8_rows)
            inv = torch.ones_like(scale) / scale
            int8_rows = int8_rows.view(S, max_embs, dim)
        strides = None
        if not self.uniform_doclen and s.rerank_dtype != "float32":
            strides = stride_buckets(doclens, row_multiple=16)
        shards = []
        for i, dev in enumerate(self.mesh.devices):
            as_dev = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
            shard = _Shard(dev, int(sh["pid_base"][i, 0]), int(sh["doclens"].shape[1]))
            coarse = as_dev(ivf["coarse_centroids"], np.float32)
            quant = (as_dev(ivf["codebooks"], np.float32) if self.codec == "pq"
                     else (as_dev(ivf["sq_proj"], np.float32), as_dev(ivf["sq_scales"], np.float32)))
            shard.lists = (coarse, quant, as_dev(sh["codes"][i], np.uint8 if self.codec == "pq" else np.int8),
                           as_dev(sh["offsets"][i], np.int32))
            shard.pid_by_row = as_dev(sh["pid_by_row"][i], np.int32)
            n_real = int(sh["num_docs"][i, 0])
            if self.int8:
                shard.table = int8_rows[i].to(dev)
                shard.inv_scale = inv.to(dev)
            elif self.uniform_doclen:
                tdt = torch.float32 if s.rerank_dtype == "float32" else torch.bfloat16
                shard.table = torch.from_numpy(sh["emb_table"][i]).to(dev).to(tdt)
            elif strides is None:
                shard.table = RaggedTable(torch.from_numpy(sh["emb_table"][i]).to(dev).float(),
                                          as_dev(sh["doc_offsets"][i][:-1], np.int64),
                                          as_dev(sh["doclens"][i], np.int64))
            else:
                dl = sh["doclens"][i][:n_real]
                raw, b_of, s_of = build_ragged_buckets(sh["emb_table"][i][: int(dl.sum())], dl, strides)
                shard.table = BucketTables(tuple(torch.from_numpy(t).to(dev).to(torch.bfloat16) for t in raw),
                                           tuple(int(x) for x in strides), torch.from_numpy(b_of).to(dev),
                                           torch.from_numpy(s_of).to(dev))
            shards.append(shard)
        return shards

    # ---- device pipeline ----

    @torch.inference_mode()
    def encode_queries(self, q_ids, q_attn, q_active) -> Tuple[torch.Tensor, torch.Tensor]:
        """Masked query reps ``(B, qv, dim)`` fp32 and the active mask ``(B, qv)``, on the first device."""
        dev = self.device
        Q = self.model.query(torch.as_tensor(q_ids).to(dev), torch.as_tensor(q_attn).to(dev))
        qm = torch.as_tensor(q_active).to(dev, torch.float32)
        return Q * qm.to(Q.dtype)[..., None], qm

    def _flat_shard(self, shard: _Shard, Qm: torch.Tensor, topk: int) -> Tuple[torch.Tensor, torch.Tensor]:
        q = Qm.to(shard.device)
        if shard.inv_scale is not None:
            q = q * shard.inv_scale
        scores = flat_maxsim_scan(q, shard.table, dv=self.flat_dv)
        ts, ti = flat_topk(scores, shard.n_docs, topk, segment=self.cfg.serve.flat_segment_docs)
        return ts, torch.where(torch.isfinite(ts), ti + shard.pid_base, -1)

    def _ann_shard(self, shard: _Shard, Qm: torch.Tensor, qm: torch.Tensor, topk: int, nprobe: int,
                   depth: int) -> Tuple[torch.Tensor, torch.Tensor]:
        s = self.cfg.serve
        q, m = Qm.to(shard.device), qm.to(shard.device)
        probe = make_probe_fn(self.codec, *shard.lists, nprobe=nprobe, cap=self.max_list_len, depth=depth,
                              probe_impl=s.probe_impl, list_topr=s.probe_list_topr,
                              hot_cap=s.probe_hot_lists or max(64, nprobe))
        pids, scores = probe_pids(q, m, probe, shard.pid_by_row)
        max_cand = min(s.max_candidates, self.num_docs)
        cand = dedup(pids, scores, q_view=q.shape[1], depth=depth, max_cand=max_cand,
                     candidate_ranking=s.candidate_ranking, dedup_impl=s.dedup_impl, num_docs=shard.n_docs)
        ts, tp = select_topk(rerank(cand, q, shard.table, shard.inv_scale, dv=self.rerank_cap), cand,
                             min(topk, max_cand))
        return ts, torch.where(tp >= 0, tp + shard.pid_base, -1)

    @torch.inference_mode()
    def search_reps(self, Qm: torch.Tensor, qm: torch.Tensor, topk: int, nprobe: Optional[int] = None,
                    depth: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every shard's pipeline from the masked query reps, then the merge:
        ``(scores, pids)`` on the first device."""
        s = self.cfg.serve
        if self.flat_dv is not None:
            k = min(topk, self.num_docs)
            parts = [self._flat_shard(sh, Qm, topk) for sh in self.shards]
        else:
            nprobe = min(nprobe or s.nprobe, self.n_lists)
            depth = depth or s.candidate_depth
            parts = [self._ann_shard(sh, Qm, qm, topk, nprobe, depth) for sh in self.shards]
            k = min(topk, self.n_shards * parts[0][0].shape[1])
        parts = [pad_shard_topk(ts.to(self.device), tp.to(self.device).int(), k) for ts, tp in parts]
        return topk_merge_gathered([p[0] for p in parts], [p[1] for p in parts], k)

    # ---- public API ----

    def search(self, questions: Sequence[str], topk: Optional[int] = None, nprobe: Optional[int] = None,
               depth: Optional[int] = None) -> SearchResult:
        enc = self.tok.encode_queries(list(questions))
        return self.search_tokens(enc.input_ids, enc.attention_mask, enc.active_mask,
                                  topk=topk, nprobe=nprobe, depth=depth)

    def search_tokens(self, q_ids, q_attn, q_active, topk: Optional[int] = None,
                      nprobe: Optional[int] = None, depth: Optional[int] = None) -> SearchResult:
        with self.timers.span("search"):
            ts, tp = self.search_tokens_device(q_ids, q_attn, q_active, topk=topk, nprobe=nprobe, depth=depth)
        return SearchResult(tp, ts)

    def search_tokens_device(self, q_ids, q_attn, q_active, topk: Optional[int] = None,
                             nprobe: Optional[int] = None, depth: Optional[int] = None) -> PendingResult:
        """Dispatch a batch; the handle synchronises when unpacked into
        ``(scores, pids)`` numpy arrays (the serving service's contract)."""
        Qm, qm = self.encode_queries(q_ids, q_attn, q_active)
        return PendingResult(*self.search_reps(Qm, qm, topk or self.cfg.serve.topk, nprobe, depth))

    def close(self) -> None:
        """Nothing to shut down (no host-table worker)."""
