"""Fused candidate gather + exact MaxSim rerank over a doc-major table.

Counterpart of ``colbert_tpu/ops/rerank_pallas.py`` for uniform-doclen
(multiview) corpora, where doc ``p`` occupies table rows
``[p*dv, (p+1)*dv)``:

    score[b, c] = sum over query b's views of max over the dv rows of
                  table[row] . Q[b, view]        (-inf where cand[b, c] < 0)

* :func:`maxsim_rerank_uniform` (K4): bf16 table, queries rounded to bf16;
* :func:`maxsim_rerank_uniform_int8` (K5): int8 table (the JAX package's
  table before ``pack_int8_table`` permutes it into 128-lane chunks; the
  port keeps it unpacked), queries in fp32 with the per-dim descale
  ``1/scale`` already multiplied in, as the TPU kernel takes them.

Both run one CUDA source (``csrc/rerank.cu``) for CUDA tensors, counted in
their ``launches`` counters, and their plain PyTorch versions (``*_ref``)
for CPU tensors.  Any candidate count works; the JAX kernels need a
multiple of 128.

A ragged corpus (multiview off: each doc its own count of rows) is served
over stride buckets (:func:`stride_buckets`, :func:`build_ragged_buckets`,
the JAX package's ``rerank_pallas.py:185-238``): per-stride zero-padded
doc-major tables, each reranked by one K4 or K5 launch with ``dv`` = its
stride (:func:`maxsim_rerank_buckets`).

The source has three routes, chosen by shape in :func:`rerank_plan`:
"wgmma" for the uniform serving shape (16 rows a doc, 16 views; any dim up
to 1,024 over a bf16 table, whole 64-dim chunks over int8): each query's
candidates sorted by pid and cut into pid
windows (:func:`rerank_schedule`, on the device without a host sync), a
persistent grid over the (window, query) items window-major, so a window's
doc blocks come from device memory about once a batch, one TMA box a doc a
stage, wgmma with each warp's doc in registers and the MaxSim there too;
"wgmma_rows" for any other count of rows a doc (the ragged stride buckets,
the host table's blocks) at up to 32 views: the same pid windows, each
(window, query) run cut into parts of at most 64 docs (32 for K5's int8
table; :func:`rerank_items`, also on the device), a doc's 16-row tiles
walked in turn with the max over rows carried in registers, wgmma n = 32
(n = 96 for K5's three terms); "staged" (the first, wmma kernel, one warp per
candidate) for every other shape, at any bf16 dim (K5's int8 at multiples
of 16: the JAX package reaches K5 at multiples of 128 only).  A bf16 dim
that is not whole 64-dim chunks reaches the wgmma routes' ring by their
producers' own copies, no tensor map.  Each counts its launches in
:data:`route_launches`.  :func:`rerank_windowed_ref` and
:func:`rerank_rows_ref` walk the two wgmma routes' items in plain torch.

A launch takes at most :data:`MAX_VIEWS` query rows; past that (and past 16
rows on the "wgmma" route's shape) the rows go in chunks, one launch each,
and the chunks' scores add up in fp32 (:func:`row_chunk`,
:func:`sum_row_chunks`): MaxSim sums over query rows, so that is exact but
for the order of the fp32 sum.  The JAX kernels take any count of rows.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from colbert_tpu_torch.ops._build import LaunchCounter

# kernel limits (a launch's), mirrored by rerank_max_views() (route "staged"),
# rerank_wgmma_dv/views/max_dim/group() (route "wgmma") and
# rerank_rows_views/part() (route "wgmma_rows") in the .cu
MAX_VIEWS = 32  # query rows routes "staged" and "wgmma_rows" take (csrc/rerank.cu MAX_QV, wr::QV)
_WGMMA_DV = 16
_WGMMA_VIEWS = 16
_WGMMA_MAX_DIM = 1024  # both wgmma routes
_WGMMA_GROUP = 8  # docs a stage: one a consumer warp (both wgmma routes)
_ROWS_PART = {False: 64, True: 32}  # docs a "wgmma_rows" item at most: bf16 (K4), int8 (K5) tables
_ROUTES = ("staged", "wgmma", "wgmma_rows")
_REF_BYTES = 1 << 30  # gathered fp32 doc rows per plain-version step
_WINDOW_BYTES = 12 << 20  # doc blocks a pid window: two windows in half the card's 50 MB L2
_MIN_ITEM_CANDS = 32  # fewest candidates an item should average (windows per query <= C / 32)
_NO_PID = torch.iinfo(torch.int32).max  # the sort key of a -1 candidate: after every pid
#: the dim each column of a 16-dim k-step holds in the int8 kernel's A
#: fragment: a thread widens bytes 4q..4q+3 of its rows into fragment columns
#: 2q, 2q+1 and 2q+8, 2q+9 (csrc/rerank.cu::load_a)
INT8_K_ORDER = (0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15)


def check_int8_table_dim(dim: int) -> None:
    """Refuses a uniform corpus's int8 rerank table at a width K5 does not
    take on the card (a multiple of 16), when the searcher is built rather
    than at its first batch, on the CPU as on the card.  The JAX searchers
    refuse every width that is not a multiple of 128 (their lane-packed
    table, ``colbert_tpu/ops/rerank_pallas.py:116-117``), so at these widths
    the two packages agree."""
    if dim % 16:
        raise ValueError(f"rerank_dtype=int8 needs a dim that is a multiple of 16 (the int8 rerank kernel's; "
                         f"the JAX package's lane-packed table needs a multiple of 128), got {dim}")


def quantize_emb_into(emb, out: torch.Tensor, *, device="cpu", chunk: int = 1 << 18) -> torch.Tensor:
    """Per-dim symmetric int8 quantization of ``emb`` (N, dim) (numpy, any
    float dtype) into ``out`` (N, dim) int8 on any device, computed on
    ``device`` chunk by chunk: ``scale = 127 / max(amax, 1e-6)`` in fp32,
    then ``rint(x * scale)`` clipped to +-127, so ``emb ~= int8 / scale``.
    Returns ``scale`` (dim,) fp32 on ``device``."""
    n, dim = emb.shape
    rows = lambda lo: torch.from_numpy(np.ascontiguousarray(emb[lo : lo + chunk])).to(device).float()
    amax = torch.zeros(dim, dtype=torch.float32, device=device)
    for lo in range(0, n, chunk):
        amax = torch.maximum(amax, rows(lo).abs().amax(dim=0))
    # tensor / tensor: a Python scalar over a tensor computes reciprocal() * scalar,
    # which is not the correctly rounded quotient numpy gives
    scale = torch.full_like(amax, 127.0) / amax.clamp_min(1e-6)
    for lo in range(0, n, chunk):
        out[lo : lo + chunk] = torch.round(rows(lo) * scale).clamp_(-127, 127).to(torch.int8)
    return scale


def quantize_emb_table(emb, chunk: int = 1 << 18) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`quantize_emb_into` on the CPU: ``(int8 (N, dim), scale (dim,)
    fp32)`` numpy arrays, bit-equal to the numpy path of the JAX package's
    ``quantize_emb_table`` (``rerank_pallas.py:241-269``)."""
    out = torch.empty(emb.shape, dtype=torch.int8)
    scale = quantize_emb_into(emb, out, chunk=chunk)
    return out.numpy(), scale.numpy()


# ---- ragged corpora: stride buckets ----

def stride_buckets(doclens, n_buckets: int = 4, row_multiple: int = 16) -> List[int]:
    """Bucket strides at the doclen percentiles 25/50/75/100 (the reference's
    bucket trick, ``colbert_ranker.py:36-41``; ``method="higher"``), each
    rounded up to ``row_multiple`` rows, deduplicated, ascending: the JAX
    package's ``stride_buckets`` (``rerank_pallas.py:185``)."""
    doclens = np.asarray(doclens)
    qs = np.percentile(doclens, np.linspace(0, 100, n_buckets + 1)[1:], method="higher")
    out: List[int] = []
    for s in qs:
        s = int(-(-int(max(s, 1)) // row_multiple) * row_multiple)
        if not out or s > out[-1]:
            out.append(s)
    return out


def build_ragged_buckets(emb, doclens, strides) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    """A ragged doc-major table ``emb`` (sum(doclens), dim) scattered into
    zero-padded doc-major tables, one a stride (``rerank_pallas.py:205``).
    Returns ``(tables, bucket_of_pid, slot_of_pid)``: doc ``p`` occupies rows
    ``slot_of_pid[p] * s`` to ``+ doclens[p]`` of ``tables[bucket_of_pid[p]]``
    (``s`` its stride, the smallest that holds it), zeros after.  A zero row
    scores 0 against every query row, as a masked row does in the
    reference's MaxSim, so a bucket needs no doclen mask.  An empty bucket
    keeps one stride of zeros."""
    doclens = np.asarray(doclens, np.int64)
    strides = np.asarray(strides, np.int64)
    offs = np.concatenate([[0], np.cumsum(doclens)])
    if doclens.size and int(doclens.max()) > int(strides[-1]):
        raise ValueError("max doclen exceeds the largest stride")
    bucket_of = np.searchsorted(strides, doclens, side="left").astype(np.int32)
    slot_of = np.zeros(len(doclens), np.int32)
    tables = []
    for b, s in enumerate(strides.tolist()):
        pids = np.nonzero(bucket_of == b)[0]
        slot_of[pids] = np.arange(len(pids), dtype=np.int32)
        tbl = np.zeros((max(len(pids), 1) * s, emb.shape[1]), emb.dtype)
        if len(pids):
            lens = doclens[pids]
            starts = np.cumsum(lens) - lens
            within = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(starts, lens)
            src = np.repeat(offs[pids], lens) + within
            dst = np.repeat(np.arange(len(pids), dtype=np.int64) * s, lens) + within
            tbl[dst] = np.asarray(emb)[src]
        tables.append(tbl)
    return tables, bucket_of, slot_of


class BucketTables(NamedTuple):
    """A ragged corpus's rerank table on the device: the stride buckets of
    :func:`build_ragged_buckets` (all bf16 or all int8)."""
    tables: Tuple[torch.Tensor, ...]  # (n_b * strides[b], dim) each
    strides: Tuple[int, ...]
    bucket_of_pid: torch.Tensor       # (num_docs,) int32
    slot_of_pid: torch.Tensor         # (num_docs,) int32


# ---- plain PyTorch versions ----

def _rerank_ref(cand: torch.Tensor, q: torch.Tensor, table: torch.Tensor, dv: int) -> torch.Tensor:
    """fp32 MaxSim of ``q`` (B, qv, dim) fp32 against each candidate's
    block of ``table`` (read as fp32): the valid (query, candidate) pairs
    only, in chunks that bound the gathered transient."""
    B, C = cand.shape
    dim = q.shape[-1]
    docs = table[: (table.shape[0] // dv) * dv].view(-1, dv, dim)
    out = torch.full((B, C), float("-inf"), dtype=torch.float32, device=q.device)
    rows, cols = torch.nonzero(cand >= 0, as_tuple=True)
    step = max(1, _REF_BYTES // ((dv + q.shape[1]) * dim * 4))
    for lo in range(0, rows.numel(), step):
        r, c = rows[lo : lo + step], cols[lo : lo + step]
        D = docs[cand[r, c].long()].float()                                # (pairs, dv, dim)
        out[r, c] = torch.einsum("nqh,ndh->nqd", q[r], D).amax(dim=-1).sum(dim=-1)
    return out


def maxsim_rerank_uniform_ref(cand: torch.Tensor, Qm: torch.Tensor, table: torch.Tensor,
                              *, dv: int) -> torch.Tensor:
    """Plain version of K4: queries rounded to bf16, table values in fp32."""
    return _rerank_ref(cand, Qm.to(torch.bfloat16).float(), table, dv)


def maxsim_rerank_uniform_int8_ref(cand: torch.Tensor, Qm: torch.Tensor, table: torch.Tensor,
                                   *, dv: int) -> torch.Tensor:
    """Plain version of K5: fp32 queries (descale folded in), int8 values in fp32."""
    return _rerank_ref(cand, Qm.float(), table, dv)


def rerank_plan(dv: int, qv: int, dim: int, int8: bool = False) -> str:
    """The kernel route for ``dv`` rows a doc, ``qv`` query views and width
    ``dim`` up to 1,024 (any, over a bf16 table; whole 64-dim chunks over
    ``int8``): "wgmma" where a warp's 16 accumulator rows are one doc and
    the 16 views one wgmma n = 16 operand; "wgmma_rows" for any other
    ``dv`` >= 1 at up to 32 views (a doc's 16-row tiles in turn, n = 32);
    else "staged"."""
    if not (1 <= dim <= _WGMMA_MAX_DIM and dv >= 1) or (int8 and dim % 64):
        return "staged"
    if (dv, qv) == (_WGMMA_DV, _WGMMA_VIEWS):
        return "wgmma"
    return "wgmma_rows" if qv <= MAX_VIEWS else "staged"


def row_chunk(dv: int, qv: int, dim: int, int8: bool = False) -> int:
    """Query rows a launch takes for ``qv`` rows: all of them up to 16, or
    up to :data:`MAX_VIEWS` off the "wgmma" route's shape (one launch, routed
    by :func:`rerank_plan`); past that, 16 where ``dv`` and ``dim`` are the
    "wgmma" route's (each chunk a 16-view "wgmma" launch, the last padded
    with zero rows), else :data:`MAX_VIEWS` (routes "wgmma_rows", whose
    launch pads a short chunk with zero rows, and "staged")."""
    if rerank_plan(dv, _WGMMA_VIEWS, dim, int8) == "wgmma" and qv > _WGMMA_VIEWS:
        return _WGMMA_VIEWS
    return min(qv, MAX_VIEWS)


def sum_row_chunks(Qm: torch.Tensor, chunk: int, score, pad: bool = False) -> torch.Tensor:
    """``score(Qm[:, lo:lo + chunk])`` over the chunks of ``Qm``'s rows (B,
    qv, dim), summed in fp32: MaxSim's sum over query rows, taken a chunk at
    a time (-inf stays -inf).  ``pad``: the last chunk filled to ``chunk``
    rows with zero rows, which add 0 to every score."""
    qv = Qm.shape[1]
    if qv <= chunk:
        return score(Qm)
    out = None
    for lo in range(0, qv, chunk):
        q = Qm[:, lo : lo + chunk]
        if pad and q.shape[1] < chunk:
            q = torch.cat([q, q.new_zeros((q.shape[0], chunk - q.shape[1], q.shape[2]))], dim=1)
        part = score(q)
        out = part if out is None else out + part
    return out


def window_docs(num_docs: int, C: int, doc_bytes: int) -> int:
    """Docs a pid window of the "wgmma" route: about two windows of doc
    blocks (``doc_bytes`` each) in half the L2, so a window's blocks stay
    there while its queries read them; but no more windows than ``C / 32``,
    so an item keeps ~32 candidates where docs are barely shared (a large
    corpus).  Fixed by the shapes: no host synchronisation."""
    per_l2 = max(1, _WINDOW_BYTES // max(1, doc_bytes))
    n_win = max(1, min(-(-num_docs // per_l2), C // _MIN_ITEM_CANDS))
    return -(-max(num_docs, 1) // n_win)


def rerank_schedule(cand: torch.Tensor, num_docs: int, window: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pid-window schedule of the "wgmma" route, on ``cand``'s device
    with no host synchronisation (sizes fixed by (B, C, num_docs)):

    * ``spid`` (B, C) int32: each row's pids sorted ascending, -1 last (as
      ``int32`` max);
    * ``perm`` (B, C) int64: the column of ``cand`` each sorted entry came from;
    * ``wstart`` (B, n_win + 1) int32: the first sorted index of each window
      of ``window`` pids, ``wstart[:, -1]`` the count of real candidates.

    Item (w, b) holds ``spid[b, wstart[b, w]:wstart[b, w + 1]]``."""
    B = cand.shape[0]
    spid, perm = torch.sort(cand.masked_fill(cand < 0, _NO_PID), dim=1)
    n_win = -(-max(num_docs, 1) // window)
    edges = torch.arange(n_win + 1, dtype=torch.int32, device=cand.device) * window
    wstart = torch.searchsorted(spid, edges.expand(B, n_win + 1).contiguous(), out_int32=True)
    return spid, perm, wstart


def rerank_windowed_ref(cand: torch.Tensor, q: torch.Tensor, table: torch.Tensor, dv: int,
                        window: int) -> torch.Tensor:
    """Plain walk over the "wgmma" route's items: window-major, each query's
    candidates of the window in groups of 8 docs, fp32 MaxSim of ``q``
    (B, qv, dim; rounded by the caller as the kernel's operand) against
    their blocks, each score written to its original column (-inf where
    nothing is).  For holding the schedule to :func:`_rerank_ref`."""
    B, C = cand.shape
    num_docs = table.shape[0] // dv
    spid, perm, wstart = rerank_schedule(cand, num_docs, window)
    docs = table[: num_docs * dv].view(num_docs, dv, -1)
    out = torch.full((B, C), float("-inf"), dtype=torch.float32, device=q.device)
    for w in range(wstart.shape[1] - 1):
        for b in range(B):
            lo, hi = int(wstart[b, w]), int(wstart[b, w + 1])
            for g0 in range(lo, hi, _WGMMA_GROUP):
                g = slice(g0, min(g0 + _WGMMA_GROUP, hi))
                D = docs[spid[b, g].long()].float()                      # (group, dv, dim)
                out[b, perm[b, g]] = torch.einsum("qh,gdh->gqd", q[b].float(), D).amax(-1).sum(-1)
    return out


def rerank_items(wstart: torch.Tensor, C: int, part: int) -> torch.Tensor:
    """The "wgmma_rows" route's work list, on ``wstart``'s device with no
    host synchronisation: each (window, query) run of :func:`rerank_schedule`
    cut into parts of at most ``part`` docs, window-major (so the blocks in
    flight share a window's docs in the L2), as an (n_items, 3) int32 tensor
    of (query, first, end) sorted indices.  ``n_items`` is fixed by the
    shapes, ``B * C // part`` plus the count of runs (at least the parts
    there are); the rows past the last part hold query -1, and no part is
    empty, so a bucket's launch spends nothing on another bucket's -1s."""
    B, n1 = wstart.shape
    runs = B * (n1 - 1)
    lo = wstart[:, :-1].t().reshape(-1).long()   # run w * B + b: window w, query b
    hi = wstart[:, 1:].t().reshape(-1).long()
    parts = (hi - lo + part - 1) // part
    ends = parts.cumsum(0)
    k = torch.arange(B * C // part + min(runs, B * C), device=wstart.device)
    run = torch.searchsorted(ends, k, right=True)
    live = run < runs
    run = run.clamp(max=runs - 1)
    first = lo[run] + (k - ends[run] + parts[run]) * part
    return torch.stack([torch.where(live, run % B, -1), first, torch.minimum(first + part, hi[run])], 1).int()


def rerank_rows_ref(cand: torch.Tensor, q: torch.Tensor, table: torch.Tensor, dv: int, window: int,
                    part: Optional[int] = None) -> torch.Tensor:
    """Plain walk over the "wgmma_rows" route's items: in list order, each
    item's docs in groups of 8, each doc's rows in 16-row tiles with the
    max over rows carried from tile to tile (rows past ``dv`` in the last
    tile are zeros and take no part), fp32 MaxSim of ``q`` (B, qv, dim;
    rounded by the caller as the kernel's operand) summed over its rows,
    each score written to its original column (-inf where nothing is).  For
    holding the work list to :func:`_rerank_ref`; ``part`` defaults to the
    kernel's for the table's type."""
    B, C = cand.shape
    num_docs = table.shape[0] // dv
    spid, perm, wstart = rerank_schedule(cand, num_docs, window)
    docs = table[: num_docs * dv].view(num_docs, dv, -1)
    out = torch.full((B, C), float("-inf"), dtype=torch.float32, device=q.device)
    part = part or _ROWS_PART[table.dtype == torch.int8]
    for b, lo, hi in rerank_items(wstart, C, part).tolist():
        if b < 0:
            break
        for g0 in range(lo, hi, _WGMMA_GROUP):
            g = slice(g0, min(g0 + _WGMMA_GROUP, hi))
            D = docs[spid[b, g].long()].float()                          # (group, dv, dim)
            mx = torch.full((D.shape[0], q.shape[1]), float("-inf"), device=q.device)
            for t0 in range(0, dv, 16):
                tile = torch.einsum("qh,gdh->gqd", q[b].float(), D[:, t0 : t0 + 16])
                mx = torch.maximum(mx, tile.amax(-1))
            out[b, perm[b, g]] = mx.sum(-1)
    return out


def query_operand(Qm: torch.Tensor, int8_table: bool) -> torch.Tensor:
    """The wgmma routes' bf16 B operand: ``bf16(Qm)`` (B, qv, dim) for a
    bf16 table, its dims padded with zeros to whole 64-dim chunks (the
    kernels' query tensor map); for int8 (dim whole chunks), ``Qm``'s three
    bf16 terms side by side (B, 3*qv, dim), whose sum is ``Qm`` to fp32
    precision (each remainder is exact in fp32), with each 16-dim block's
    dims in :data:`INT8_K_ORDER`: the order in which the kernel widens a
    thread's int8 words into its A fragment."""
    if not int8_table:
        q = Qm.to(torch.bfloat16)
        return torch.nn.functional.pad(q, (0, -q.shape[-1] % 64)) if q.shape[-1] % 64 else q.contiguous()
    q = Qm.float()
    t0 = q.to(torch.bfloat16)
    r = q - t0.float()
    t1 = r.to(torch.bfloat16)
    t2 = (r - t1.float()).to(torch.bfloat16)
    terms = torch.cat([t0, t1, t2], dim=1)
    B, n, dim = terms.shape
    # dim 4q + 2h + e of a block goes to column 8h + 2q + e: a view, no index tensor to copy
    return terms.view(B, n, dim // 16, 4, 2, 2).transpose(3, 4).reshape(B, n, dim).contiguous()


# ---- the CUDA kernel ----

_lib_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    from colbert_tpu_torch.ops._build import load_library

    lib = load_library("rerank")
    with _lib_lock:
        if lib.rerank_launch.argtypes is None:
            lib.rerank_launch.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            )
            lib.rerank_launch.restype = ctypes.c_int
            lib.rerank_wgmma_launch.argtypes = (
                [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                + [ctypes.c_void_p]
            )
            lib.rerank_wgmma_launch.restype = ctypes.c_int
            lib.rerank_rows_launch.argtypes = (
                [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                + [ctypes.c_void_p]
            )
            lib.rerank_rows_launch.restype = ctypes.c_int
            limits = (lib.rerank_max_views, lib.rerank_wgmma_dv, lib.rerank_wgmma_views,
                      lib.rerank_wgmma_max_dim, lib.rerank_wgmma_group, lib.rerank_rows_views)
            for fn in limits:
                fn.argtypes, fn.restype = [], ctypes.c_int
            lib.rerank_rows_part.argtypes, lib.rerank_rows_part.restype = [ctypes.c_int], ctypes.c_int
            if tuple(fn() for fn in limits) + (lib.rerank_rows_part(0), lib.rerank_rows_part(1)) != (
                    MAX_VIEWS, _WGMMA_DV, _WGMMA_VIEWS, _WGMMA_MAX_DIM, _WGMMA_GROUP, MAX_VIEWS,
                    _ROWS_PART[False], _ROWS_PART[True]):
                raise RuntimeError("csrc/rerank.cu limits disagree with ops/rerank.py")
    return lib


def _launch(cand: torch.Tensor, Qm: torch.Tensor, table: torch.Tensor, dv: int,
            table_dtype: torch.dtype, counter: LaunchCounter, route: Optional[str] = None) -> torch.Tensor:
    """The kernel over ``Qm``'s rows in chunks of :func:`row_chunk`, one
    launch a chunk on the route :func:`rerank_plan` picks for it, each
    counted in ``counter`` and in :data:`route_launches`; the chunks' scores
    summed (:func:`sum_row_chunks`).  ``route`` "staged" forces the first
    design on any shape (``chip_smoke.py`` times it beside the wgmma
    routes)."""
    dev = table.device
    if not (cand.is_cuda and Qm.is_cuda and cand.device == Qm.device == dev):
        raise ValueError("rerank kernel needs cand, Qm and table on one CUDA device")
    if table.dtype != table_dtype or table.dim() != 2:
        raise ValueError(f"rerank kernel takes a 2-D {table_dtype} table, got {table.dtype} {tuple(table.shape)}")
    B, qv, dim = Qm.shape
    if cand.dim() != 2 or cand.shape[0] != B or cand.dtype != torch.int32:
        raise ValueError(f"cand must be ({B}, C) int32, got {tuple(cand.shape)} {cand.dtype}")
    int8 = table_dtype == torch.int8
    if table.shape[1] != dim or dim < 1:
        raise ValueError(f"rerank kernel needs a table of width {dim}, got {tuple(table.shape)}")
    if int8 and dim % 16:
        raise ValueError(f"rerank kernel over an int8 table needs a width that is a multiple of 16, got {dim}")
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("rerank kernel needs a contiguous, 16-byte aligned table")
    C = cand.shape[1]
    chunk = min(qv, MAX_VIEWS) if route == "staged" else row_chunk(dv, qv, dim, int8)
    plan = rerank_plan(dv, chunk, dim, int8)
    route = route or plan
    if route not in ("staged", plan):
        raise ValueError(f"rerank route {route!r} does not take dv {dv}, {qv} views, dim {dim}")
    if B == 0 or C == 0 or qv == 0:  # nothing to launch: a sum over no query rows is 0
        return torch.where(cand >= 0, 0.0, float("-inf")).float()
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cand = cand.contiguous()
    num_docs = table.shape[0] // dv
    if route != "staged":  # the pid-window schedule depends on cand alone: once a call
        window = window_docs(num_docs, C, dv * dim * table.element_size())
        spid, perm, wstart = rerank_schedule(cand, num_docs, window)
        if route == "wgmma_rows":
            items = rerank_items(wstart, C, _ROWS_PART[int8])

    def one(q_rows: torch.Tensor) -> torch.Tensor:
        if route == "staged":
            q = q_rows.float().contiguous()
            out = torch.empty((B, C), dtype=torch.float32, device=dev)
            with torch.cuda.device(dev):
                err = lib.rerank_launch(cand.data_ptr(), q.data_ptr(), table.data_ptr(), int(int8),
                                        out.data_ptr(), B, C, q.shape[1], dim, dv, stream)
        else:
            if route == "wgmma_rows" and q_rows.shape[1] < MAX_VIEWS:  # zero rows add 0 to every score
                q_rows = torch.cat([q_rows, q_rows.new_zeros((B, MAX_VIEWS - q_rows.shape[1], dim))], dim=1)
            q = query_operand(q_rows, int8)  # dims padded to whole 64-dim chunks
            if q.data_ptr() % 16:  # the tensor map needs a 16-byte aligned base
                q = q.clone()
            out = torch.full((B, C), float("-inf"), dtype=torch.float32, device=dev)
            with torch.cuda.device(dev):
                if route == "wgmma":
                    err = lib.rerank_wgmma_launch(q.data_ptr(), table.data_ptr(), int(int8), spid.data_ptr(),
                                                  perm.data_ptr(), wstart.data_ptr(), out.data_ptr(), B, C, dim,
                                                  num_docs, wstart.shape[1] - 1, stream)
                else:
                    err = lib.rerank_rows_launch(q.data_ptr(), table.data_ptr(), int(int8), spid.data_ptr(),
                                                 perm.data_ptr(), items.data_ptr(), out.data_ptr(), B, C, dim, dv,
                                                 num_docs, items.shape[0], stream)
        if err != 0:
            raise RuntimeError(f"rerank kernel launch failed ({route} route): cudaError_t {err} "
                               f"(Q {tuple(q_rows.shape)}, table {tuple(table.shape)}, dv {dv})")
        counter.add()
        route_launches[route].add()
        return out

    return sum_row_chunks(Qm, chunk, one, pad=route == "wgmma")


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def maxsim_rerank_uniform(cand: torch.Tensor, Qm: torch.Tensor, table: torch.Tensor,
                          *, dv: int) -> torch.Tensor:
    """K4: exact MaxSim (B, C) fp32 of each candidate pid (-1: -inf, no
    bytes read) against ``Qm`` (B, qv, dim) rounded to bf16, over a bf16
    table (num_docs * dv, dim); any ``qv``, past one launch's rows a launch
    a chunk of rows (:func:`row_chunk`)."""
    if _on_cpu(cand, Qm, table):
        return maxsim_rerank_uniform_ref(cand, Qm, table, dv=dv)
    return _launch(cand, Qm, table, dv, torch.bfloat16, maxsim_rerank_uniform.launches)


def maxsim_rerank_uniform_int8(cand: torch.Tensor, Qm: torch.Tensor, table: torch.Tensor,
                               *, dv: int) -> torch.Tensor:
    """K5: K4 over an int8 table (num_docs * dv, dim); ``Qm`` stays fp32
    and carries the descale ``1/scale``."""
    if _on_cpu(cand, Qm, table):
        return maxsim_rerank_uniform_int8_ref(cand, Qm, table, dv=dv)
    return _launch(cand, Qm, table, dv, torch.int8, maxsim_rerank_uniform_int8.launches)


def _buckets(cand: torch.Tensor, q: torch.Tensor, tables: Sequence[torch.Tensor], strides: Sequence[int],
             bucket_of_pid: torch.Tensor, slot_of_pid: torch.Tensor, rerank) -> torch.Tensor:
    """``rerank(cand_b, q, table, dv=stride)`` once a bucket, each
    candidate given as its slot in its own bucket's call and as -1 in the
    others'; the scores combine by an elementwise max."""
    safe = cand.clamp(min=0).long()
    b_of = torch.where(cand >= 0, bucket_of_pid[safe], -1)
    s_of = slot_of_pid[safe]
    scores = torch.full(cand.shape, float("-inf"), dtype=torch.float32, device=cand.device)
    for b, (table, stride) in enumerate(zip(tables, strides)):
        scores = torch.maximum(scores, rerank(torch.where(b_of == b, s_of, -1), q, table, dv=stride))
    return scores


def _bucket_query(Qm: torch.Tensor, tables: Sequence[torch.Tensor], inv_scale: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, bool]:
    int8 = tables[0].dtype == torch.int8
    if int8 and inv_scale is None:
        raise ValueError("int8 bucket tables need their descale inv_scale")
    return (Qm.float() * inv_scale if int8 else Qm), int8


def maxsim_rerank_buckets(cand: torch.Tensor, Qm: torch.Tensor, tables: Sequence[torch.Tensor],
                          strides: Sequence[int], bucket_of_pid: torch.Tensor, slot_of_pid: torch.Tensor,
                          inv_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact MaxSim (B, C) fp32 of each candidate pid of a ragged corpus
    over its stride buckets (-1: -inf), the JAX searcher's ragged branch
    (``colbert_tpu/ranking/searcher.py:257-285``): one K4 launch a bucket
    over bf16 tables (``Qm`` rounded to bf16), or one K5 launch a bucket over
    int8 tables (``Qm * inv_scale`` in fp32).  A bucket's launch sees the
    other buckets' candidates as -1 slots, which move no bytes."""
    q, int8 = _bucket_query(Qm, tables, inv_scale)
    return _buckets(cand, q, tables, strides, bucket_of_pid, slot_of_pid,
                    maxsim_rerank_uniform_int8 if int8 else maxsim_rerank_uniform)


def maxsim_rerank_buckets_ref(cand: torch.Tensor, Qm: torch.Tensor, tables: Sequence[torch.Tensor],
                              strides: Sequence[int], bucket_of_pid: torch.Tensor, slot_of_pid: torch.Tensor,
                              inv_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`maxsim_rerank_buckets`: each bucket by its
    kernel's plain version."""
    q, int8 = _bucket_query(Qm, tables, inv_scale)
    return _buckets(cand, q, tables, strides, bucket_of_pid, slot_of_pid,
                    maxsim_rerank_uniform_int8_ref if int8 else maxsim_rerank_uniform_ref)


maxsim_rerank_uniform.launches = LaunchCounter()
maxsim_rerank_uniform_int8.launches = LaunchCounter()
#: launches of each kernel route, K4 and K5 together
route_launches = {route: LaunchCounter() for route in _ROUTES}
