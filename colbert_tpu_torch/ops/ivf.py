"""IVF layout, the sq probe and the candidate dedups.

Counterpart of ``colbert_tpu/ops/ivf.py`` (and the numpy paths of
``colbert_tpu/native/lib.py``'s ``ivf_pack`` / ``balanced_assign``).
Embeddings are stored flat, sorted by IVF list (CSR):

    codes_sorted : (N, sq_dim) int8   rows grouped by list
    row_emb      : (N,)        int32  sorted row -> embedding id
    offsets      : (K+1,)      int32  list l holds rows [offsets[l], offsets[l+1])

The dedups take a whole query batch at once, ``(B, n)``, where the JAX
package maps one query at a time; each query's result is the same.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from colbert_tpu_torch.ops.sq import sq_query
from colbert_tpu_torch.ops.sq_probe_batched import (
    SlotSchedule, build_slot_schedule_dense, probe_batched_postprocess, sq_batch_list_scan,
    sq_hot_list_scan,
)

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
    """(perm (N,) int32, offsets (K+1,) int32, codes sorted by list)."""
    perm, offsets = sort_by_list(np.ascontiguousarray(assignments, np.int32), num_lists)
    return perm.astype(np.int32), offsets, np.ascontiguousarray(codes)[perm]


def balanced_assign(candidates: np.ndarray, num_lists: int, cap: int) -> np.ndarray:
    """Capacity-constrained assignment from per-point nearest-centroid
    candidates (N, kc), best first: each point, in order, takes its first
    candidate with fewer than ``cap`` rows; a point with none spills, after
    the pass, to the least-filled list (the earliest on a tie)."""
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


def sq_probe_plan(q_tokens: torch.Tensor, coarse_centroids: torch.Tensor, proj: torch.Tensor,
                  scales: torch.Tensor, *, nprobe: int, tpl: int = 128, hot_cap: int = 64,
                  groups: int = 8) -> ProbePlan:
    """Coarse probe, hot-list choice and slot schedule (``colbert_tpu/ops/ivf.py:273-322``).

    Membership is ``coarse >= thr`` over an exact coarse top-``nprobe``.
    The ``hot_cap`` most-probed lists with more members than their
    ``groups * tpl`` slots hold go to K7; the rest fill the slots."""
    K = coarse_centroids.shape[0]
    hot_cap = min(hot_cap, K)
    dev = q_tokens.device
    coarse = q_tokens.float() @ coarse_centroids.float().T                 # (T, K)
    vals, lists = torch.topk(coarse, nprobe, dim=1)
    member = coarse >= vals[:, -1:]
    hot_ids = hot_pos = None
    if hot_cap > 0:
        hot_vals, hot_raw = torch.sort(member.sum(dim=0), descending=True, stable=True)
        hot_ids = torch.where(hot_vals[:hot_cap] > groups * tpl, hot_raw[:hot_cap], -1).int()
        hot_pos = torch.full((K + 1,), -1, dtype=torch.int32, device=dev)
        hot_pos.scatter_(0, torch.where(hot_ids >= 0, hot_ids, K).long(),
                         torch.arange(hot_cap, dtype=torch.int32, device=dev))
        hot_pos = hot_pos[:K]
        member = member & (hot_pos < 0)[None, :]  # the slots handle the cold tail
    sched, pair_valid = build_slot_schedule_dense(member, lists, tpl=tpl, groups=groups)
    return ProbePlan(lists, sched, pair_valid, hot_ids, hot_pos, sq_query(q_tokens, proj, scales))


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
    from K6 (slots) and K7 (hot lists); pairs past a cold list's slots are
    dropped.  The final selection is an exact top-k: the JAX package takes
    ``approx_max_k`` on a TPU and ``top_k`` on the CPU."""
    plan = sq_probe_plan(q_tokens, coarse_centroids, proj, scales, nprobe=nprobe, tpl=tpl,
                         hot_cap=hot_cap, groups=groups)
    out_s, out_r = sq_batch_list_scan(plan.sched.qidx, offsets, plan.qs, codes, r=r)
    hot = None
    if plan.hot_ids is not None:
        hot = (plan.hot_pos, *sq_hot_list_scan(plan.hot_ids, offsets, plan.qs, codes, r=r))
    return probe_batched_postprocess(plan.sched, out_s, out_r, plan.lists, depth, plan.pair_valid, hot=hot)


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
