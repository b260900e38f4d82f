"""IVF layout, the sq and pq probes and the candidate dedups.

Counterpart of ``colbert_tpu/ops/ivf.py``; the index build's CSR pack and
balanced assignment run in the port's C++ host runtime
(``colbert_tpu_torch/native``), with numpy/Python plain versions beside them.
Embeddings are stored flat, sorted by IVF list (CSR):

    codes_sorted : (N, width)  codes  rows grouped by list
    row_emb      : (N,)        int32  sorted row -> embedding id
    offsets      : (K+1,)      int32  list l holds rows [offsets[l], offsets[l+1])

Every probe takes each token's exact coarse top-``nprobe`` lists (the JAX
package takes ``approx_max_k`` on a TPU where it is asked to) and returns
each token's top-``depth`` (scores, CSR rows), -inf / -1 padded.  The
dedups take a whole query batch at once, ``(B, n)``, where the JAX package
maps one query at a time; each query's result is the same.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from colbert_tpu_torch import native
from colbert_tpu_torch.ops.pq import adc_lut
from colbert_tpu_torch.ops.sq import sq_query
from colbert_tpu_torch.ops.sq_probe import _window_topk, sq_window_topk, topk_first  # noqa: F401 (re-exported)
from colbert_tpu_torch.ops.sq_probe_batched import (
    SlotSchedule, build_slot_schedule_dense, probe_batched_postprocess, sq_batch_list_scan,
    sq_hot_list_scan,
)

_ADC_ELEMS = 1 << 26   # LUT gathers per token chunk of the pq probe

# ---- index build (host) ----


def sort_by_list(assignments: np.ndarray, num_lists: int) -> Tuple[np.ndarray, np.ndarray]:
    """CSR packing: a stable sort of rows by list id.  Returns (perm (N,),
    offsets (K+1,) int32)."""
    perm = np.argsort(assignments, kind="stable").astype(np.int64)
    counts = np.bincount(assignments, minlength=num_lists)
    offsets = np.zeros(num_lists + 1, np.int32)
    np.cumsum(counts, out=offsets[1:])
    return perm, offsets


def ivf_pack(assignments: np.ndarray, codes: np.ndarray, num_lists: int
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(perm (N,) int32, offsets (K+1,) int32, codes sorted by list): the C++
    counting sort.  ``codes`` of any one-byte dtype (sq's int8, pq's and
    pq4's uint8) pass through as bytes and come back in their own dtype."""
    codes = np.ascontiguousarray(codes)
    if codes.dtype.itemsize != 1:
        raise ValueError(f"codes must have a one-byte dtype, got {codes.dtype}")
    perm, offsets, packed = native.ivf_pack(assignments, codes.view(np.uint8), num_lists)
    return perm, offsets, packed.view(codes.dtype)


def ivf_pack_ref(assignments: np.ndarray, codes: np.ndarray, num_lists: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`ivf_pack` by a stable argsort and a gather."""
    perm, offsets = sort_by_list(np.ascontiguousarray(assignments, np.int32), num_lists)
    return perm.astype(np.int32), offsets, np.ascontiguousarray(codes)[perm]


def balanced_assign(candidates: np.ndarray, num_lists: int, cap: int) -> np.ndarray:
    """Capacity-constrained assignment from per-point nearest-centroid
    candidates (N, kc), best first: each point, in order, takes its first
    candidate with fewer than ``cap`` rows; a point with none spills, after
    the pass, to the least-filled list (the earliest on a tie).  The C++
    loop; :func:`balanced_assign_ref` is the plain version."""
    return native.balanced_assign(candidates, num_lists, cap)


def balanced_assign_ref(candidates: np.ndarray, num_lists: int, cap: int) -> np.ndarray:
    """:func:`balanced_assign` in Python."""
    candidates = np.ascontiguousarray(candidates, np.int32)
    n = candidates.shape[0]
    out = np.empty(n, np.int32)
    fill = np.zeros(num_lists, np.int64)
    spill = []
    for i, row in enumerate(candidates.tolist()):
        for a in row:
            if 0 <= a < num_lists and fill[a] < cap:
                out[i] = a
                fill[a] += 1
                break
        else:
            spill.append(i)
    for i in spill:
        a = int(np.argmin(fill))
        out[i] = a
        fill[a] += 1
    return out


# ---- the sq probe ----


class ProbePlan(NamedTuple):
    """What the sq probe's kernels take for one token batch."""
    lists: torch.Tensor        # (T, nprobe) probed list ids, best first
    sched: SlotSchedule        # K6's slots
    pair_valid: torch.Tensor   # (T*nprobe,) pairs served by their slot
    hot_ids: Optional[torch.Tensor]  # (hot_cap,) K7's lists, -1 none; None when hot_cap == 0
    hot_pos: Optional[torch.Tensor]  # (K,) position of a list in hot_ids, -1 cold
    qs: torch.Tensor           # (T, sq_dim) projected queries, fp32
    hot_members: Optional[torch.Tensor] = None  # (T, hot_cap) bool: token t probes hot list h


def sq_probe_plan(q_tokens: torch.Tensor, coarse_centroids: torch.Tensor, proj: torch.Tensor,
                  scales: torch.Tensor, *, nprobe: int, tpl: int = 128, hot_cap: int = 64,
                  groups: int = 8) -> ProbePlan:
    """Coarse probe, hot-list choice and slot schedule (``colbert_tpu/ops/ivf.py:273-322``).

    Membership is ``coarse >= thr`` over an exact coarse top-``nprobe``.
    The ``hot_cap`` most-probed lists with more members than their
    ``groups * tpl`` slots hold go to K7, with their member tokens (a
    superset of the pairs the postprocess reads: membership counts a tie
    at a token's threshold); the rest fill the slots."""
    K = coarse_centroids.shape[0]
    hot_cap = min(hot_cap, K)
    dev = q_tokens.device
    coarse = q_tokens.float() @ coarse_centroids.float().T                 # (T, K)
    vals, lists = torch.topk(coarse, nprobe, dim=1)
    member = coarse >= vals[:, -1:]
    hot_ids = hot_pos = hot_members = None
    if hot_cap > 0:
        hot_vals, hot_raw = torch.sort(member.sum(dim=0), descending=True, stable=True)
        hot_ids = torch.where(hot_vals[:hot_cap] > groups * tpl, hot_raw[:hot_cap], -1).int()
        hot_pos = torch.full((K + 1,), -1, dtype=torch.int32, device=dev)
        hot_pos.scatter_(0, torch.where(hot_ids >= 0, hot_ids, K).long(),
                         torch.arange(hot_cap, dtype=torch.int32, device=dev))
        hot_pos = hot_pos[:K]
        hot_members = member[:, hot_ids.clamp(min=0).long()]  # a -1 entry's column is never read
        member = member & (hot_pos < 0)[None, :]  # the slots handle the cold tail
    sched, pair_valid = build_slot_schedule_dense(member, lists, tpl=tpl, groups=groups)
    return ProbePlan(lists, sched, pair_valid, hot_ids, hot_pos, sq_query(q_tokens, proj, scales), hot_members)


def ivf_probe_sq_batched(
    q_tokens: torch.Tensor,          # (T, d) query token embeddings
    coarse_centroids: torch.Tensor,  # (K, d) fp32
    proj: torch.Tensor,              # (d, sq_dim)
    scales: torch.Tensor,            # (sq_dim,)
    codes: torch.Tensor,             # (N, sq_dim) int8, CSR-sorted by list
    offsets: torch.Tensor,           # (K+1,) int32
    *,
    nprobe: int,
    depth: int,
    tpl: int = 128,
    r: int = 2,
    hot_cap: int = 64,
    groups: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """List-major sq probe (``colbert_tpu/ops/ivf.py:232``): each token's
    top-``depth`` (scores (T, depth) fp32, CSR rows (T, depth) int32, -inf /
    -1 padded) over the top-``r`` rows of each of its ``nprobe`` lists,
    from K6 (slots) and K7 (hot lists, over their member tokens); pairs
    past a cold list's slots are dropped.  The final selection is an exact
    top-k: the JAX package takes ``approx_max_k`` on a TPU and ``top_k`` on
    the CPU."""
    plan = sq_probe_plan(q_tokens, coarse_centroids, proj, scales, nprobe=nprobe, tpl=tpl,
                         hot_cap=hot_cap, groups=groups)
    out_s, out_r = sq_batch_list_scan(plan.sched.qidx, offsets, plan.qs, codes, r=r)
    hot = None
    if plan.hot_ids is not None:
        hot = (plan.hot_pos, *sq_hot_list_scan(plan.hot_ids, offsets, plan.qs, codes, r=r,
                                               members=plan.hot_members))
    return probe_batched_postprocess(plan.sched, out_s, out_r, plan.lists, depth, plan.pair_valid, hot=hot)


# ---- the token-major probes ----


def coarse_lists(q_tokens: torch.Tensor, coarse_centroids: torch.Tensor, nprobe: int) -> torch.Tensor:
    """Each token's ``nprobe`` best lists, best first, as ``sq_probe_plan``
    takes them."""
    return torch.topk(q_tokens.float() @ coarse_centroids.float().T, nprobe, dim=1)[1]


def ivf_probe_sq(
    q_tokens: torch.Tensor,          # (T, d) query token embeddings
    coarse_centroids: torch.Tensor,  # (K, d)
    proj: torch.Tensor,              # (d, sq_dim)
    scales: torch.Tensor,            # (sq_dim,)
    codes: torch.Tensor,             # (N, sq_dim) int8, CSR-sorted by list
    offsets: torch.Tensor,           # (K+1,) int32
    *,
    nprobe: int,
    cap: int,
    depth: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-major sq probe (``colbert_tpu/ops/ivf.py:137``, its Pallas
    path): each token's exact coarse top-``nprobe`` lists, then
    :func:`~colbert_tpu_torch.ops.sq_probe.sq_window_topk` scores up to
    ``cap`` rows of each against the token's fp32 projected query and keeps
    its exact top-``depth`` over all its probed rows (ties: the lower
    (probe rank, row) first, as ``top_k``).  On the card that is one launch
    of route "fused" for the batch, or, past its depth, route "staged": the
    dense scores and a torch top-k, a launch per token chunk."""
    lists = coarse_lists(q_tokens, coarse_centroids, nprobe)
    qs = sq_query(q_tokens, proj, scales)
    starts = offsets[lists]
    lens = (offsets[lists + 1] - starts).clamp(max=cap)
    return sq_window_topk(starts, lens, qs, codes, cap=cap, depth=depth)


def ivf_probe_adc(
    q_tokens: torch.Tensor,          # (T, d) query token embeddings
    coarse_centroids: torch.Tensor,  # (K, d)
    codebooks: torch.Tensor,         # (m, ksub, dsub)
    codes: torch.Tensor,             # (N, m) uint8, CSR-sorted by list
    offsets: torch.Tensor,           # (K+1,) int32
    *,
    nprobe: int,
    cap: int,
    depth: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """pq probe (``colbert_tpu/ops/ivf.py:66``) by the JAX package's rule
    for a GPU, ``adc_method="gather"``: ADC-score up to ``cap`` rows of each
    probed list with an fp32 LUT gather summed over the ``m`` subspaces,
    then each token's exact top-``depth`` (ties as ``top_k``).  Torch ops,
    no kernel; tokens go in chunks that bound the (tokens, nprobe*cap, m)
    gather index to ``_ADC_ELEMS``."""
    T = q_tokens.shape[0]
    m, ksub, _ = codebooks.shape
    dev = q_tokens.device
    lists = coarse_lists(q_tokens, coarse_centroids, nprobe)
    lut = adc_lut(q_tokens, codebooks).reshape(T, m * ksub)
    starts = offsets[lists]
    lens = offsets[lists + 1] - starts
    i = torch.arange(cap, device=dev)
    sub = torch.arange(m, device=dev) * ksub
    n_rows = codes.shape[0]
    tc = max(1, _ADC_ELEMS // (nprobe * cap * m))
    out = []
    for lo in range(0, T, tc):
        idx = starts[lo : lo + tc].long()[..., None] + i                    # (n, nprobe, cap)
        n = idx.shape[0]
        c = codes[idx.clamp(0, n_rows - 1).view(-1)].long() + sub          # (n*nprobe*cap, m)
        s = lut[lo : lo + tc].gather(1, c.view(n, -1)).view(n, nprobe * cap, m).sum(dim=-1)
        s = s.masked_fill(~(i < lens[lo : lo + tc].long()[..., None]).view(n, -1), float("-inf"))
        out.append(_window_topk(s, starts[lo : lo + tc], cap, depth))
    return torch.cat([s for s, _ in out]), torch.cat([r for _, r in out])


# ---- candidate dedup ----

_SENTINEL = 1 << 62


def _runs(keys: torch.Tensor):
    """Rows of ``keys`` (B, n) int64 sorted ascending, flattened: the run
    (maximal block of equal keys within a row) of each element, and each
    run's first position (N where a run id is unused)."""
    B, n = keys.shape
    N = B * n
    flat = keys.reshape(-1)
    dev = keys.device
    first = torch.ones(N, dtype=torch.bool, device=dev)
    if N > 1:
        row_start = torch.zeros(N, dtype=torch.bool, device=dev)
        row_start[::n] = True
        first[1:] = (flat[1:] != flat[:-1]) | row_start[1:]
    run = torch.cumsum(first, dim=0) - 1
    pos = torch.arange(N, device=dev)
    start = torch.full((N,), N, dtype=torch.int64, device=dev).scatter_reduce(
        0, run, pos, "amin", include_self=True)
    return run, start


def _top_per_query(seg_row: torch.Tensor, seg_pid: torch.Tensor, seg_score: torch.Tensor,
                   B: int, n: int, max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per query, the ``max_out`` best pid segments (segments come sorted by
    (query, pid); ties keep that order, as ``top_k`` keeps index order).
    Unused segments carry ``seg_row == B``.  Returns (pids (B, max_out)
    int32, -1 padded; scores fp32, -inf padded)."""
    dev = seg_score.device
    N = seg_row.shape[0]
    row_first = torch.full((B + 1,), N, dtype=torch.int64, device=dev).scatter_reduce(
        0, seg_row, torch.arange(N, device=dev), "amin", include_self=True)
    col = torch.arange(N, device=dev) - row_first[seg_row]
    col = torch.where(seg_row < B, col, 0)
    S = torch.full((B + 1, n), float("-inf"), dtype=torch.float32, device=dev)
    P = torch.full((B + 1, n), -1, dtype=torch.int64, device=dev)
    S[seg_row, col] = seg_score
    P[seg_row, col] = seg_pid
    S, P = S[:B], P[:B]
    k = min(max_out, n)
    top_s, i = torch.sort(S, dim=1, descending=True, stable=True)
    top_s = top_s[:, :k]
    pids = torch.where(torch.isfinite(top_s), P.gather(1, i[:, :k]), -1).int()
    if k < max_out:
        top_s = torch.nn.functional.pad(top_s, (0, max_out - k), value=float("-inf"))
        pids = torch.nn.functional.pad(pids, (0, max_out - k), value=-1)
    return pids, top_s


def dedup_pids_by_approx_maxsim(pids: torch.Tensor, token_ids: torch.Tensor, scores: torch.Tensor,
                                num_tokens: int, max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate docs ranked by approximate MaxSim over the sampled rows
    (``colbert_tpu/ops/ivf.py:347``): per (query, pid), the sum over query
    tokens of the best score that token found for the pid; then each
    query's top-``max_out`` pids.

    ``pids``/``scores`` (B, n), -1 / -inf invalid; ``token_ids`` (n,).
    Returns (pids (B, max_out) int32 -1 padded, doc scores fp32 -inf
    padded).  The per-pid sums add the token maxima in token order."""
    B, n = pids.shape
    dev = pids.device
    valid = pids >= 0
    key = torch.where(valid, pids.long() * num_tokens + token_ids.long()[None, :], _SENTINEL)
    sk, perm = torch.sort(key, dim=1, stable=True)
    ss = scores.float().gather(1, perm).reshape(-1)
    run, start = _runs(sk)
    N = B * n
    run_max = torch.full((N,), float("-inf"), device=dev).scatter_reduce(0, run, ss, "amax")
    used = start < N
    first = start.clamp(max=N - 1)
    rkey = sk.reshape(-1)[first]
    rrow = first // n
    rvalid = used & (rkey != _SENTINEL)
    rpid = torch.where(rvalid, rkey // num_tokens, -1)
    rtok = torch.where(rvalid, rkey % num_tokens, 0)
    # pid segments over the runs, which are in (query, pid, token) order
    pkey = torch.where(rvalid, rrow * (1 << 32) + rpid, -1)
    pfirst = torch.ones(N, dtype=torch.bool, device=dev)
    pfirst[1:] = pkey[1:] != pkey[:-1]
    seg = torch.cumsum(pfirst, dim=0) - 1
    contrib = torch.where(rvalid & torch.isfinite(run_max), run_max, 0.0)
    M = torch.zeros((N, num_tokens), dtype=torch.float32, device=dev)
    M[seg, rtok] = torch.where(rvalid, contrib, 0.0)
    doc_sum = M.sum(dim=1)
    seg_row = torch.full((N,), B, dtype=torch.int64, device=dev).scatter(
        0, seg, torch.where(rvalid, rrow, B))
    seg_pid = torch.full((N,), -1, dtype=torch.int64, device=dev).scatter(0, seg, rpid)
    seg_score = torch.where(seg_row < B, doc_sum, float("-inf"))
    return _top_per_query(seg_row, seg_pid, seg_score, B, n, max_out)


def _segment_sum_scan(val: torch.Tensor, reset: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Along each row of ``val`` (B, n) fp32, the running sum that restarts
    where ``reset`` (B, n) bool is set: ``jax.lax.associative_scan`` of the
    segmented add, on its tree (pairs, the scan of the pairs, then the even
    positions), so every fp32 sum adds the same terms in the same order as
    the JAX package's dedup."""
    n = val.shape[1]
    if n < 2:
        return val, reset

    def combine(av, ar, bv, br):
        return torch.where(br, bv, av + bv), ar | br

    odd_v, odd_r = _segment_sum_scan(*combine(val[:, 0:-1:2], reset[:, 0:-1:2], val[:, 1::2], reset[:, 1::2]))
    k = odd_v.shape[1] - (n % 2 == 0)
    even_v, even_r = combine(odd_v[:, :k], odd_r[:, :k], val[:, 2::2], reset[:, 2::2])
    out_v, out_r = torch.empty_like(val), torch.empty_like(reset)
    out_v[:, :1], out_v[:, 2::2], out_v[:, 1::2] = val[:, :1], even_v, odd_v
    out_r[:, :1], out_r[:, 2::2], out_r[:, 1::2] = reset[:, :1], even_r, odd_r
    # JAX interleaves by adding zero-padded halves: every value gains a + 0.0 (-0.0 becomes +0.0)
    return out_v + 0.0, out_r


def dedup_pids_by_approx_maxsim_packed(pids: torch.Tensor, token_ids: torch.Tensor, scores: torch.Tensor,
                                       num_tokens: int, max_out: int, num_docs: int
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed form of :func:`dedup_pids_by_approx_maxsim`
    (``colbert_tpu/ops/ivf.py:402``): each entry one int32 key, (pid, token)
    in the high bits and the score quantised per query to ``sbits`` bits in
    the low bits, one single-operand sort, and each (pid, token) run's
    maximum its last element.  Only which pids pass matters (an exact rerank
    follows).  The final budget is an exact top-``max_out`` with the TPU
    tie rule (:func:`topk_first`): ``approx_max_k`` is exact off the TPU.

    ``pids``/``scores`` (B, n), -1 / -inf invalid; ``token_ids`` (n,).
    Returns (pids (B, max_out) int32 -1 padded, doc scores fp32 -inf
    padded).  Raises ``ValueError`` where the key leaves fewer than 6 bits
    for the score."""
    B, n = pids.shape
    kt_bits = max(1, int(np.ceil(np.log2(max(2, num_docs * num_tokens)))))
    sbits = min(12, 31 - kt_bits)
    if sbits < 6:
        raise ValueError("pid*token key too wide to pack; use the exact dedup")
    levels = (1 << sbits) - 1
    inf = float("inf")
    s = scores.float()
    valid = (pids >= 0) & torch.isfinite(s)
    lo = torch.where(valid, s, inf).amin(dim=1, keepdim=True)
    hi = torch.where(valid, s, -inf).amax(dim=1, keepdim=True)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(hi > lo, hi, lo + 1.0)
    # the JAX package's fp32 arithmetic as XLA runs it: the division by the
    # constant ``levels`` is a product with its fp32 reciprocal, and
    # ``lo + x * step`` below one fused multiply-add (exact in fp64, then
    # rounded once to fp32)
    step = (hi - lo) * float(np.float32(1.0 / levels))
    q = torch.clamp(torch.round((s - lo) / step), 0, levels).int()
    kt = pids.int() * num_tokens + token_ids.int()[None, :]
    big = torch.iinfo(torch.int32).max
    sp = torch.sort(torch.where(valid, (kt << sbits) | q, big), dim=1).values
    rk = torch.where(sp != big, sp >> sbits, -1)
    last = torch.ones((B, 1), dtype=torch.bool, device=pids.device)
    run_last = torch.cat([rk[:, 1:] != rk[:, :-1], last], dim=1)
    run_max = (lo.double() + (sp & levels).double() * step.double()).float()
    spid = torch.where(rk >= 0, rk // num_tokens, -1)
    pid_first = torch.cat([last, spid[:, 1:] != spid[:, :-1]], dim=1)
    doc_sum, _ = _segment_sum_scan(torch.where(run_last & (spid >= 0), run_max, 0.0), pid_first)
    pid_last = torch.cat([pid_first[:, 1:], last], dim=1)
    doc_score = torch.where(pid_last & (spid >= 0), doc_sum, -inf)
    k = min(max_out, n)
    top_s, top_i = topk_first(doc_score, k)
    out = torch.where(torch.isfinite(top_s), spid.gather(1, top_i), -1).int()
    if k < max_out:
        top_s = torch.nn.functional.pad(top_s, (0, max_out - k), value=-inf)
        out = torch.nn.functional.pad(out, (0, max_out - k), value=-1)
    return out, top_s


def dedup_pids_by_score(pids: torch.Tensor, scores: torch.Tensor, max_out: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unique pids per query, each with its best codec score, and each
    query's top-``max_out`` by that score (``colbert_tpu/ops/ivf.py:478``).
    ``pids``/``scores`` (B, n), -1 invalid."""
    B, n = pids.shape
    dev = pids.device
    key = torch.where(pids >= 0, pids.long(), _SENTINEL)
    sk, perm = torch.sort(key, dim=1, stable=True)
    ss = scores.float().gather(1, perm).reshape(-1)
    run, start = _runs(sk)
    N = B * n
    best = torch.full((N,), float("-inf"), device=dev).scatter_reduce(0, run, ss, "amax")
    first = start.clamp(max=N - 1)
    rkey = sk.reshape(-1)[first]
    valid = (start < N) & (rkey != _SENTINEL) & torch.isfinite(best)
    seg_row = torch.where(valid, first // n, B)
    seg_pid = torch.where(valid, rkey, -1)
    return _top_per_query(seg_row, seg_pid, torch.where(valid, best, float("-inf")), B, n, max_out)
