"""Exact brute-force MaxSim serving scan -- the flat (no-ANN) retrieval mode.

Counterpart of ``colbert_tpu/ops/flat_scan.py``.  Every document of a
doc-major, zero-padded table ``(docs_pad * dv, h)`` (bf16, or int8 with the
per-dim descale folded into the queries) is scored against every query:

    score[doc, b] = sum over b's m views of max over the doc's dv rows of
                    table[row] . bf16(Qm[b, view])

Queries are rounded to bf16 before the product even when the caller passes
fp32, as the TPU kernels do; products accumulate in fp32; zero rows score 0.

Two kernel entries share one CUDA source (``csrc/flat_scan.cu``):

* :func:`flat_maxsim_scan` (K2): the full ``(docs_pad, B)`` fp32 score matrix,
  selected with :func:`flat_topk`;
* :func:`flat_scan_fused` (K1): scores rounded to the stored dtype, docs
  ``>= num_docs`` set to -inf, plus one fp32 max per (doc group, query).
  :func:`flat_scan_topk` adds the exact stage-2 selection in torch.

The source has two routes, chosen by shape in :func:`flat_scan_plan`:
"wgmma" (TMA ring, wgmma, MaxSim in registers) for 16 rows a doc and 16
views a query, the multiview main path; "staged" (the first, wmma kernel)
for every other shape.  Each counts its launches in :data:`route_launches`.
Both take any hidden dim ``h >= 1``, as the TPU kernels do: the queries go
to the kernel zero-padded to whole 64-dim chunks (:func:`query_operand`),
and a table whose row pitch is not a multiple of 16 bytes (int8 at h 312,
bf16 at h 100), which no tensor map describes, is copied into the "wgmma"
route's ring by its producer warps.

Each wrapper runs its plain PyTorch version (``*_ref``) only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises, and counts the
launch in its ``launches`` counter.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from colbert_tpu_torch.ops._build import LaunchCounter

# kernel limits, mirrored by flat_scan_max_tokens()/flat_scan_max_group() (route
# "staged") and flat_scan_wgmma_dv()/flat_scan_wgmma_m() (route "wgmma") in the .cu
_MAX_TOKENS = 128
_MAX_GROUP = 64
_WGMMA_DV = 16
_WGMMA_M = 16
_ROUTES = {"staged": 0, "wgmma": 1}
_GROUP_ROWS = 1024
_REF_ROWS_CHUNK = 1 << 15  # table rows per product in the plain version
_SCORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pick_rows_block(dv: int, itemsize: int, target_rows: int = 1024) -> int:
    """The JAX package's table padding unit (``colbert_tpu/ops/flat_scan.py:47``):
    tables built here keep its ``docs_pad`` so the two are bit-equal."""
    sub = {1: 32, 2: 16, 4: 8}[itemsize]
    docs_unit = 8
    while (docs_unit * dv) % sub:
        docs_unit += 8
    unit = docs_unit * dv
    return max(unit, (target_rows // unit) * unit)


def group_docs(dv: int) -> int:
    """Docs per stage-2 group, and per block on the "staged" route: about
    1,024 table rows, at most 64 docs.  Stage 2 is exact for any size."""
    return max(1, min(_MAX_GROUP, _GROUP_ROWS // dv))


def flat_scan_plan(dv: int, m: int) -> str:
    """The kernel route for a table of ``dv`` rows a doc and queries of ``m``
    views: "wgmma" where a warp's 16 accumulator rows are one doc and a
    256-token tile is 16 whole queries, else "staged".  Both take bf16 and
    int8 tables and any hidden dim."""
    return "wgmma" if (dv, m) == (_WGMMA_DV, _WGMMA_M) else "staged"


# ---- the CUDA kernel ----

_lib_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    from colbert_tpu_torch.ops._build import load_library

    lib = load_library("flat_scan")
    with _lib_lock:
        if lib.flat_scan_launch.argtypes is None:
            lib.flat_scan_launch.argtypes = (
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                + [ctypes.c_int] * 9 + [ctypes.c_void_p]
            )
            lib.flat_scan_launch.restype = ctypes.c_int
            limits = (lib.flat_scan_max_tokens, lib.flat_scan_max_group,
                      lib.flat_scan_wgmma_dv, lib.flat_scan_wgmma_m)
            for fn in limits:
                fn.argtypes, fn.restype = [], ctypes.c_int
            if tuple(fn() for fn in limits) != (_MAX_TOKENS, _MAX_GROUP, _WGMMA_DV, _WGMMA_M):
                raise RuntimeError("csrc/flat_scan.cu limits disagree with ops/flat_scan.py")
    return lib


def _check_kernel_inputs(Qm: torch.Tensor, table: torch.Tensor, dv: int) -> None:
    if not (Qm.is_cuda and table.is_cuda and Qm.device == table.device):
        raise ValueError(
            f"flat scan kernel needs Qm and table on one CUDA device, got {Qm.device} and {table.device}"
        )
    B, m, h = Qm.shape
    if table.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"flat scan kernel takes a bf16 or int8 table, got {table.dtype}")
    if table.dim() != 2 or table.shape[1] != h:
        raise ValueError(f"table {tuple(table.shape)} does not match query dim {h}")
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("flat scan kernel needs a contiguous, 16-byte aligned table")
    if h < 1:
        raise ValueError(f"flat scan kernel needs a hidden dim of at least 1, got {h}")
    if not 1 <= m <= _MAX_TOKENS:
        raise ValueError(f"flat scan kernel takes 1..{_MAX_TOKENS} views per query, got {m}")
    if dv < 1 or table.shape[0] % dv or table.shape[0] == 0:
        raise ValueError(f"table rows {table.shape[0]} are not whole docs of dv={dv}")
    if B < 1:
        raise ValueError("flat scan kernel needs at least one query")


def query_operand(Qm: torch.Tensor) -> torch.Tensor:
    """The kernel's query operand: ``Qm`` (B, m, h) as bf16 rows (B*m, hq),
    ``hq`` = h rounded up to a multiple of 64 (the kernel's 64-dim chunks),
    zeros past h, 16-byte aligned (the kernel reads whole 16-byte vectors
    and the "wgmma" route's tensor map needs an aligned base)."""
    B, m, h = Qm.shape
    q = Qm.reshape(B * m, h).to(torch.bfloat16)
    if h % 64:
        return torch.nn.functional.pad(q, (0, -h % 64))
    q = q.contiguous()
    return q.clone() if q.data_ptr() % 16 else q


def _launch(Qm: torch.Tensor, table: torch.Tensor, dv: int, num_docs: int,
            score_dtype: Optional[str]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One kernel launch on the route :func:`flat_scan_plan` picks.
    ``score_dtype=None`` is K2 (full fp32 matrix, no group max);
    ``"float32"``/``"bfloat16"`` is K1."""
    _check_kernel_inputs(Qm, table, dv)
    lib = _kernel_lib()
    B, m, h = Qm.shape
    dev = table.device
    route = flat_scan_plan(dv, m)
    q = query_operand(Qm)
    docs_pad = table.shape[0] // dv
    group = group_docs(dv)
    if score_dtype is None:
        mode, sdt = 0, torch.float32
    else:
        mode, sdt = (1 if score_dtype == "float32" else 2), _SCORE_DTYPES[score_dtype]
    scores = torch.empty((docs_pad, B), dtype=sdt, device=dev)
    gmax = None
    if mode:
        shape = (-(-docs_pad // group), B)
        # route "wgmma" folds its tiles into the group max with atomics, from -inf
        gmax = (torch.full(shape, float("-inf"), dtype=torch.float32, device=dev) if route == "wgmma"
                else torch.empty(shape, dtype=torch.float32, device=dev))
    with torch.cuda.device(dev):
        err = lib.flat_scan_launch(
            q.data_ptr(), table.data_ptr(), int(table.dtype == torch.int8),
            scores.data_ptr(), gmax.data_ptr() if gmax is not None else None,
            B, m, h, dv, docs_pad, num_docs, group, mode, _ROUTES[route],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flat_scan kernel launch failed ({route} route): cudaError_t {err}")
    route_launches[route].add()
    return scores, gmax


def _on_cpu(Qm: torch.Tensor, table: torch.Tensor) -> bool:
    return Qm.device.type == "cpu" and table.device.type == "cpu"


# ---- plain PyTorch versions ----

def flat_maxsim_scan_ref(Qm: torch.Tensor, table: torch.Tensor, *, dv: int) -> torch.Tensor:
    """Plain version of K2: ``(docs_pad, B)`` fp32, chunked over table rows
    so the (rows, tokens) transient stays bounded."""
    B, m, h = Qm.shape
    n_rows = table.shape[0]
    q = Qm.reshape(B * m, h).to(torch.bfloat16).float().to(table.device)
    rows_chunk = max(dv, (min(_REF_ROWS_CHUNK, n_rows) // dv) * dv)
    out = torch.empty((n_rows // dv, B), dtype=torch.float32, device=table.device)
    for lo in range(0, n_rows, rows_chunk):
        hi = min(lo + rows_chunk, n_rows)
        s = table[lo:hi].float() @ q.T                       # (rows, B*m)
        out[lo // dv : hi // dv] = s.view(-1, dv, B, m).amax(dim=1).sum(dim=-1)
    return out


def flat_scan_fused_ref(Qm: torch.Tensor, table: torch.Tensor, *, dv: int, num_docs: int,
                        score_dtype: str = "bfloat16") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: stored scores (rounded, pad docs -inf) and the
    per-(group, query) fp32 max over the rounded values."""
    s = flat_maxsim_scan_ref(Qm, table, dv=dv).to(_SCORE_DTYPES[score_dtype])
    docs_pad, B = s.shape
    s[num_docs:] = float("-inf")
    group = group_docs(dv)
    n_groups = -(-docs_pad // group)
    padded = torch.full((n_groups * group, B), float("-inf"), device=s.device)
    padded[:docs_pad] = s.float()
    return s, padded.view(n_groups, group, B).amax(dim=1)


# ---- kernel wrappers ----

def flat_maxsim_scan(Qm: torch.Tensor, table: torch.Tensor, *, dv: int) -> torch.Tensor:
    """K2: score every document against every query -> (docs_pad, B) fp32.

    ``table`` rows beyond a doc's length and rows of pad docs must be zero."""
    if _on_cpu(Qm, table):
        return flat_maxsim_scan_ref(Qm, table, dv=dv)
    scores, _ = _launch(Qm, table, dv, num_docs=0, score_dtype=None)
    flat_maxsim_scan.launches.add()
    return scores


def flat_scan_fused(Qm: torch.Tensor, table: torch.Tensor, *, dv: int, num_docs: int,
                    score_dtype: str = "bfloat16") -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 stage 1: stored scores ``(docs_pad, B)`` in ``score_dtype`` with docs
    ``>= num_docs`` at -inf, and group maxima ``(n_groups, B)`` fp32 over
    groups of :func:`group_docs` docs."""
    if score_dtype not in _SCORE_DTYPES:
        raise ValueError(f"score_dtype must be 'float32' or 'bfloat16', got {score_dtype!r}")
    if _on_cpu(Qm, table):
        return flat_scan_fused_ref(Qm, table, dv=dv, num_docs=num_docs, score_dtype=score_dtype)
    out = _launch(Qm, table, dv, num_docs=num_docs, score_dtype=score_dtype)
    flat_scan_fused.launches.add()
    return out


flat_maxsim_scan.launches = LaunchCounter()
flat_scan_fused.launches = LaunchCounter()
#: launches of each kernel route, K1 and K2 together
route_launches = {route: LaunchCounter() for route in _ROUTES}


# ---- selection ----

def select_topk(scores: torch.Tensor, gmax: torch.Tensor, *, group: int, num_docs: int,
                topk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 stage 2: per query, the top-k groups by max, then the top-k over
    only those groups' scores.  Exact for the stored dtype: if a top-k doc's
    group were outside the top-k groups, k other groups would each hold a doc
    scoring above it.  Returns ``(scores (B, k) fp32, pids (B, k) int32)``,
    pids -1 where the score is not finite."""
    docs_pad, B = scores.shape
    n_groups = gmax.shape[0]
    k = min(topk, num_docs, docs_pad)
    kg = min(k, n_groups)
    dev = scores.device
    _, gi = torch.topk(gmax.T, kg, dim=1)                                  # (B, kg)
    idx = (gi[..., None] * group + torch.arange(group, device=dev)).reshape(B, kg * group)
    vals = scores[idx.clamp_max(docs_pad - 1), torch.arange(B, device=dev)[:, None]].float()
    vals = vals.masked_fill(idx >= num_docs, float("-inf"))
    ts, sel = torch.topk(vals, k, dim=1)
    tp = idx.gather(1, sel)
    tp = torch.where(torch.isfinite(ts), tp, torch.full_like(tp, -1))
    return ts, tp.int()


def flat_scan_topk(Qm: torch.Tensor, table: torch.Tensor, *, dv: int, num_docs: int,
                   topk: int, score_dtype: str = "bfloat16") -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused flat serve: K1 scan + exact two-stage top-k.
    Returns ``(scores (B, k) fp32, pids (B, k) int32)``."""
    scores, gmax = flat_scan_fused(Qm, table, dv=dv, num_docs=num_docs, score_dtype=score_dtype)
    return select_topk(scores, gmax, group=group_docs(dv), num_docs=num_docs, topk=topk)


def flat_topk(scores_db: torch.Tensor, num_docs: int, topk: int, *,
              segment: int = 1 << 17) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-query top-k over the doc axis of a ``(docs_pad, B)`` score
    matrix, segmented so the transposed transient stays small: the global
    top-k lies in the union of the per-segment top-k.  Pad docs are masked
    per segment."""
    docs_pad, B = scores_db.shape
    k = min(topk, num_docs)
    ts = ti = None
    for start in range(0, docs_pad, segment):
        blk = scores_db[start : start + segment]
        rows = torch.arange(start, start + blk.shape[0], device=blk.device)
        blk = blk.float().masked_fill((rows >= num_docs)[:, None], float("-inf"))
        ts1, ti1 = torch.topk(blk.T, min(k, blk.shape[0]), dim=1)
        ti1 = ti1 + start
        if ts is None:
            ts, ti = ts1, ti1
            continue
        cs, ci = torch.cat([ts, ts1], dim=1), torch.cat([ti, ti1], dim=1)
        ts, sel = torch.topk(cs, min(k, cs.shape[1]), dim=1)
        ti = ci.gather(1, sel)
    return ts, ti.int()


# ---- table ----

def _int8_scale(emb, chunk: int) -> torch.Tensor:
    """Per-dim ``127 / max(amax, 1e-6)`` in fp32 (``quantize_emb_table``'s rule)."""
    amax = torch.zeros(emb.shape[1], dtype=torch.float32)
    for lo in range(0, emb.shape[0], chunk):
        c = torch.from_numpy(np.ascontiguousarray(emb[lo : lo + chunk]))
        amax = torch.maximum(amax, c.float().abs().amax(dim=0))
    # tensor / tensor: a Python scalar over a tensor computes reciprocal() * scalar,
    # which is not the correctly rounded quotient numpy gives
    return torch.tensor(127.0) / amax.clamp_min(1e-6)


def build_flat_table(emb, doclens, *, dv: Optional[int] = None, dtype: str = "bfloat16",
                     rows_blk: Optional[int] = None, chunk: int = 1 << 18, scale: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """Host-side doc-major zero-padded table (a CPU tensor) for the scan.

    Uniform corpora (multiview) copy rows as they are; ragged corpora are
    padded to ``dv = max(doclens)`` rows per doc (zero rows score 0: exact).
    ``dtype``: "bfloat16" (round-to-nearest-even from the stored fp16) or
    "int8" (per-dim ``rint(x * 127/amax)`` clipped to +-127; the descale
    ``1/scale`` is returned; ``scale`` given, that per-dim scale instead:
    one scale over every shard of a sharded table).  The layout, padding and
    values are bit-equal to ``colbert_tpu.ops.flat_scan.build_flat_table``.
    Returns ``(table (docs_pad*dv, h), inv_scale (h,) or None, dv)``."""
    doclens = np.asarray(doclens, np.int64)
    num_docs = len(doclens)
    h = emb.shape[1]
    if dv is None:
        dv = int(doclens.max()) if num_docs else 1
    if (doclens > dv).any():
        raise ValueError(f"doclens exceed dv={dv}")
    tdt = {"bfloat16": torch.bfloat16, "int8": torch.int8}.get(dtype)
    if tdt is None:
        raise ValueError(f"flat table dtype must be bfloat16 or int8, got {dtype!r}")
    inv_scale = None
    if dtype != "int8":
        scale = None
    elif scale is None:
        scale = _int8_scale(emb, chunk)
    if scale is not None:
        inv_scale = torch.ones_like(scale) / scale

    def convert(c) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(c))
        if scale is not None:
            return torch.round(t.float() * scale).clamp_(-127, 127).to(torch.int8)
        return t.to(tdt)

    rb = rows_blk or pick_rows_block(dv, tdt.itemsize)
    docs_pad = _ceil_to(max(num_docs, 1) * dv, rb) // dv
    table = torch.zeros((docs_pad * dv, h), dtype=tdt)
    n_rows = int(doclens.sum())
    if num_docs and (doclens == dv).all():
        for lo in range(0, n_rows, chunk):
            hi = min(lo + chunk, n_rows)
            table[lo:hi] = convert(emb[lo:hi])
    elif n_rows:
        # destination row of every source row: doc * dv + position in doc
        starts = np.cumsum(doclens) - doclens
        dst = np.repeat(np.arange(num_docs, dtype=np.int64) * dv - starts, doclens)
        dst += np.arange(n_rows, dtype=np.int64)
        for lo in range(0, n_rows, chunk):
            hi = min(lo + chunk, n_rows)
            table[torch.from_numpy(dst[lo:hi])] = convert(emb[lo:hi])
    return table, inv_scale, dv
