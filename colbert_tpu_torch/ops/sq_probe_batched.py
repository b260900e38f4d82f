"""List-major batched sq probe: scan each probed IVF list once per batch.

Counterpart of ``colbert_tpu/ops/sq_probe_batched.py``:

1. :func:`build_slot_schedule_dense` groups the batch's (token, list) probe
   pairs into slots: list ``l`` owns slots ``g*K + l`` for ``g < groups``,
   each holding up to ``tpl`` of its member tokens in ascending token order
   (member = the list is among the token's exact top-``nprobe``).
2. K6 (:func:`sq_batch_list_scan`) scans every filled slot's list once
   against the slot's tokens and keeps a top-``r`` of (score, CSR row) per
   token; K7 (:func:`sq_hot_list_scan`) scans the hottest lists -- those
   with more members than a list's slots hold -- against their member
   tokens (every token, as the TPU kernel, when no membership is given).
3. :func:`probe_batched_postprocess` maps the results back to (token,
   probed list) pairs and takes each token's top-``depth`` over its
   ``nprobe * r`` entries.

Both kernels live in ``csrc/sq_probe.cu``, each with two routes, counted
in :data:`route_launches` (K6) and :data:`hot_route_launches` (K7):

* "mma", every shape each takes (:func:`scan_plan`): a work list of the
  filled slots, most work first, built on the device by kernels of its own
  (plain version: :func:`slot_work_list`; no host sync); a persistent grid
  walks it, products on the tensor cores (int8 codes widened exactly to
  bf16, ``mma.sync`` with fp32 accumulation), each token's top-``r`` taken
  from the score tile.  K6's B operand is its tokens rounded to bf16.
  K7's slots are each hot list's member tokens, 128 a slot, laid out on
  the device in the same launch (plain version: :func:`hot_member_schedule`),
  and its B operand the fp32 query as three bf16 terms (:func:`query_terms`);
* "staged", the first design of both (one block per dense slot or per
  (hot list, 128 tokens), one thread per token, fp32 FMA chains; K7 over
  every token), reached only when asked for (``_launch(..., route=
  "staged")``), so that a run can check and time both on one input.

The TPU kernels' 128-lane packing, block-diagonal query bands and 32-row
aligned DMA windows are not carried over: a kernel reads exactly its
list's rows ``[offsets[l], offsets[l+1])`` of the unpadded codes, so the
JAX package's ``pad_codes_for_scan`` has no counterpart.  The TPU kernel's 128-row
blocks still decide ties (see the plain versions), so rows equal the JAX
package's wherever scores are not tied across its blocks.

Each wrapper runs its plain PyTorch version (``*_ref``) only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises, and counts
the launch in its ``launches`` counter.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from colbert_tpu_torch.ops._build import LaunchCounter

BLOCK_ROWS = 128  # the TPU kernel's block; it sets the tie rule
ALIGN_ROWS = 32   # a list's first block starts at its offset rounded down to this
_SQ_DIMS = (16, 32, 64, 128)
_MAX_TOKENS = 128  # tokens per slot (tpl); mirrored by sq_scan_max_tokens() in the .cu
_MAX_R = 16
_ROUTES = ("mma", "staged")
_REF_ELEMS = 1 << 24  # score elements per plain-version step


class SlotSchedule(NamedTuple):
    qidx: torch.Tensor          # (groups*K, tpl) int32 token per slot position, -1 empty
    slot_of_pair: torch.Tensor  # (T*nprobe,) int64 slot of pair (t, j), t-major
    pos_of_pair: torch.Tensor   # (T*nprobe,) int64 position within that slot


def build_slot_schedule_dense(member: torch.Tensor, lists: torch.Tensor, *, tpl: int,
                              groups: int = 8) -> Tuple[SlotSchedule, torch.Tensor]:
    """Sort-free slot schedule from the membership matrix.

    ``member`` (T, K) bool: list l is among token t's probed lists (and is
    handled by the slots, i.e. not hot).  ``lists`` (T, nprobe): the probed
    list ids.  The ``groups * tpl`` smallest member token ids of each list
    fill its slots in order, so a pair's (slot, position) follows from the
    member-count prefix ``cumsum(member, axis=0) - 1``.  A pair is valid
    when it is a member and its rank is within the list's slots.

    Returns (schedule with slot id ``g*K + l``, pair_valid (T*nprobe,) bool),
    as ``colbert_tpu/ops/sq_probe_batched.py:148``."""
    T, K = member.shape
    cap = groups * tpl
    dev = member.device
    rank = torch.cumsum(member, dim=0, dtype=torch.int32) - 1                # (T, K)
    keep = member & (rank < cap)
    lidx = torch.arange(K, device=dev, dtype=torch.int64)
    # token t goes to qidx[l, rank]; everything else to one discarded cell
    dest = torch.where(keep, lidx[None, :] * cap + rank, K * cap)
    tok = torch.arange(T, device=dev, dtype=torch.int32)[:, None].expand(T, K)
    buf = torch.full((K * cap + 1,), -1, dtype=torch.int32, device=dev)
    buf.scatter_(0, dest.reshape(-1), tok.reshape(-1))
    qidx = buf[: K * cap].view(K, groups, tpl).transpose(0, 1).reshape(groups * K, tpl)

    nprobe = lists.shape[1]
    l_flat = lists.reshape(-1).long()
    t_flat = torch.arange(T, device=dev).repeat_interleave(nprobe)
    r = rank[t_flat, l_flat].long()
    pair_valid = member[t_flat, l_flat] & (r < cap)
    r = r.clamp(0, cap - 1)
    return SlotSchedule(qidx.contiguous(), (r // tpl) * K + l_flat, r % tpl), pair_valid


WORK_STAGE_ROWS = 64  # rows a stage of route "mma"; the work list orders slots by stages
WORK_BUCKETS = 16     # stage counts the work list tells apart (longer lists share the last)
WORK_EXTRA = 2 + 2 * WORK_BUCKETS  # work-buffer words past the S items (csrc: sq_slot_work_words)


def slot_work_list(qidx: torch.Tensor, offsets: torch.Tensor, lmap: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of route "mma"'s work list (the CUDA source builds it
    on the device): (items (S,) int32, count () int32).  Slot s scans list
    ``s % K`` (K6), or ``lmap[s % H]`` (K7: ``lmap`` = hot_ids (H,), a -1
    entry's slots never filled).  ``items[:count]`` are the filled slots
    (``qidx[s, 0] >= 0``, a slot on an empty list included), the most 64-row
    stages of work first (stage counts above 15 tie), equal counts in slot
    order here (the kernel's order within equal counts follows its
    atomics); the empty slots follow."""
    S = qidx.shape[0]
    lens = (offsets[1:] - offsets[:-1]).long()
    filled = qidx[:, 0] >= 0
    if lmap is not None:
        lens = torch.where(lmap >= 0, lens[lmap.clamp(min=0).long()], 0)
        filled &= (lmap >= 0).repeat(-(-S // lmap.shape[0]))[:S]
    lens = lens.repeat(-(-S // lens.shape[0]))[:S]  # slot s scans list s % K
    stages = ((lens + WORK_STAGE_ROWS - 1) // WORK_STAGE_ROWS).clamp(max=WORK_BUCKETS - 1)
    items = torch.sort(torch.where(filled, stages, -1), descending=True, stable=True)[1].int()
    return items, filled.sum(dtype=torch.int32)


def hot_member_schedule(hot_ids: torch.Tensor, T: int, members: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K7's slots on route "mma" (the CUDA source lays
    them out on the device): qidx (G*H, 128) int32, G = ceil(T / 128).  Hot
    entry h's member tokens (``members[:, h]`` of the (T, H) bool mask, or
    every token), ascending, fill its slots ``g*H + h`` in order, -1 past
    the last: the member-count prefix of :func:`build_slot_schedule_dense`
    with capacity for every token.  A -1 entry's slots are all -1 here; the
    kernel leaves them unwritten."""
    H = hot_ids.shape[0]
    G = -(-T // _MAX_TOKENS)
    dev = hot_ids.device
    m = torch.ones((T, H), dtype=torch.bool, device=dev) if members is None else members.bool()
    m = m & (hot_ids >= 0)[None, :]
    rank = torch.cumsum(m, dim=0, dtype=torch.int64) - 1                     # (T, H)
    hidx = torch.arange(H, device=dev)
    dest = torch.where(m, ((rank // _MAX_TOKENS) * H + hidx) * _MAX_TOKENS + rank % _MAX_TOKENS,
                       G * H * _MAX_TOKENS)
    tok = torch.arange(T, device=dev, dtype=torch.int32)[:, None].expand(T, H)
    buf = torch.full((G * H * _MAX_TOKENS + 1,), -1, dtype=torch.int32, device=dev)
    buf.scatter_(0, dest.reshape(-1), tok.reshape(-1))
    return buf[:-1].view(G * H, _MAX_TOKENS)


def query_terms(qs: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """The B operand of route "mma" as the kernel builds it: (terms, T, D)
    bf16, term j the bf16 rounding of what terms 0..j-1 leave of fp32 ``qs``
    (each remainder exact in fp32).  One term is K6's bf16 query; K7's three
    sum to ``qs`` exactly (for normal floats), so its products are fp32's."""
    rest = qs.float()
    out = []
    for _ in range(terms):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].float()
    return torch.stack(out)


def scan_plan(D: int, tpl: int, r: int) -> str:
    """The kernel route of K6 and K7 for sq_dim ``D``, ``tpl`` tokens a slot
    (K7: 128) and ``r`` rows a token: "mma" for every shape they take (``D``
    in 16, 32, 64, 128; ``tpl`` 1..128; ``r`` 1..16); raises on any other."""
    if D not in _SQ_DIMS:
        raise ValueError(f"sq list scan kernel takes sq_dim in {_SQ_DIMS}, got {D}")
    if not 1 <= tpl <= _MAX_TOKENS:
        raise ValueError(f"sq list scan kernel takes 1..{_MAX_TOKENS} tokens per slot, got {tpl}")
    if not 1 <= r <= _MAX_R:
        raise ValueError(f"sq list scan kernel keeps 1..{_MAX_R} rows per token, got r={r}")
    return "mma"


# ---- plain PyTorch version of both kernels ----

def _scan_ref(lists: torch.Tensor, tokens: torch.Tensor, offsets: torch.Tensor,
              qs: torch.Tensor, codes: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per unit u: list ``lists[u]`` (-1 none) against tokens ``tokens[u]``
    (-1 empty) -> top-``r`` (scores (U, r, P) fp32, CSR rows (U, r, P)).

    Emulates the TPU kernel's merge: the list is cut into 128-row blocks
    starting at its offset rounded down to 32 rows; a block's top-r is
    taken with the lowest row first among ties (a stable sort over rows in
    ascending order), then merged with the held top-r with the block's
    entries first among ties (a stable sort of [block, held])."""
    U, P = tokens.shape
    dev = qs.device
    out_s = torch.full((U, r, P), float("-inf"), dtype=torch.float32, device=dev)
    out_r = torch.full((U, r, P), -1, dtype=torch.int32, device=dev)
    units = torch.nonzero(lists >= 0).flatten()
    if units.numel() == 0 or codes.shape[0] == 0:
        return out_s, out_r
    n_rows = codes.shape[0]
    step = max(1, _REF_ELEMS // (BLOCK_ROWS * P))
    for i in range(0, units.numel(), step):
        u = units[i : i + step]
        l = lists[u].long()
        lo, hi = offsets[l].long(), offsets[l + 1].long()
        start = lo - lo % ALIGN_ROWS
        tok = tokens[u].long()                                             # (n, P)
        q = qs[tok.clamp(min=0)] * (tok >= 0)[..., None]                   # (n, P, D)
        st_s = torch.full((u.numel(), r, P), float("-inf"), dtype=torch.float32, device=dev)
        st_r = torch.full((u.numel(), r, P), -1, dtype=torch.int64, device=dev)
        n_blocks = int(((hi - start + BLOCK_ROWS - 1) // BLOCK_ROWS).max())
        for b in range(n_blocks):
            rows = start[:, None] + b * BLOCK_ROWS + torch.arange(BLOCK_ROWS, device=dev)
            inwin = (rows >= lo[:, None]) & (rows < hi[:, None])           # (n, 128)
            c = codes[rows.clamp(0, n_rows - 1)].float()                   # (n, 128, D)
            s = torch.bmm(c, q.transpose(1, 2))                            # (n, 128, P)
            s = s.masked_fill(~inwin[..., None], float("-inf"))
            bs, bi = torch.sort(s, dim=1, descending=True, stable=True)
            k = min(r, BLOCK_ROWS)
            bs, br = bs[:, :k], rows[:, :, None].expand(-1, -1, P).gather(1, bi[:, :k])
            ms, mi = torch.sort(torch.cat([bs, st_s], dim=1), dim=1, descending=True, stable=True)
            st_s, st_r = ms[:, :r], torch.cat([br, st_r], dim=1).gather(1, mi[:, :r])
        st_r = torch.where(torch.isfinite(st_s), st_r, -1)
        empty = (tok < 0)[:, None, :]
        out_s[u] = st_s.masked_fill(empty, float("-inf"))
        out_r[u] = st_r.masked_fill(empty, -1).int()
    return out_s, out_r


def sq_batch_list_scan_ref(qidx: torch.Tensor, offsets: torch.Tensor, qs: torch.Tensor,
                           codes: torch.Tensor, *, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6.  ``qs`` (T, D) fp32 is rounded to bf16 here, as
    the TPU kernel rounds ``qsT``.  Empty slots (``qidx[s, 0] < 0``) get
    -inf / -1 here; the kernel leaves them unwritten."""
    K = offsets.shape[0] - 1
    S = qidx.shape[0]
    slots = torch.arange(S, device=qidx.device)
    lists = torch.where(qidx[:, 0] >= 0, slots % K, -1)
    return _scan_ref(lists, qidx, offsets, qs.to(torch.bfloat16).float(), codes, r)


def sq_hot_list_scan_ref(hot_ids: torch.Tensor, offsets: torch.Tensor, qs: torch.Tensor,
                         codes: torch.Tensor, *, r: int, members: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7: the member tokens (``members`` (T, H) bool, or
    every token), fp32 ``qs`` (not rounded).  A -1 entry of ``hot_ids`` and
    a non-member entry get -inf / -1 here; the kernel leaves them unwritten."""
    T = qs.shape[0]
    tokens = torch.arange(T, device=qs.device, dtype=torch.int32).expand(hot_ids.shape[0], T)
    if members is not None:
        tokens = torch.where(members.T.bool(), tokens, -1)
    return _scan_ref(hot_ids, tokens, offsets, qs.float(), codes, r)


# ---- the CUDA kernels ----

_lib_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    from colbert_tpu_torch.ops._build import load_library

    lib = load_library("sq_probe")
    with _lib_lock:
        if lib.sq_list_scan_launch.argtypes is None:
            lib.sq_list_scan_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            lib.sq_list_scan_launch.restype = ctypes.c_int
            lib.sq_slot_scan_mma_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            lib.sq_slot_scan_mma_launch.restype = ctypes.c_int
            lib.sq_slot_work_list_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            lib.sq_slot_work_list_launch.restype = ctypes.c_int
            lib.sq_hot_scan_mma_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            lib.sq_hot_scan_mma_launch.restype = ctypes.c_int
            lib.sq_hot_schedule_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            lib.sq_hot_schedule_launch.restype = ctypes.c_int
            lib.sq_hot_scratch_words.argtypes, lib.sq_hot_scratch_words.restype = [ctypes.c_int] * 2, ctypes.c_int
            lib.sq_slot_work_words.argtypes, lib.sq_slot_work_words.restype = [ctypes.c_int], ctypes.c_int
            if lib.sq_slot_work_words(0) != WORK_EXTRA or lib.sq_hot_scratch_words(3, 129) != _hot_scratch(3, 129):
                raise RuntimeError("csrc/sq_probe.cu work-list buckets disagree with ops/sq_probe_batched.py")
            for fn in (lib.sq_scan_max_tokens, lib.sq_scan_max_r):
                fn.argtypes, fn.restype = [], ctypes.c_int
            if (lib.sq_scan_max_tokens(), lib.sq_scan_max_r()) != (_MAX_TOKENS, _MAX_R):
                raise RuntimeError("csrc/sq_probe.cu limits disagree with ops/sq_probe_batched.py")
    return lib


def work_list_kernel(qidx: torch.Tensor, offsets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route "mma"'s work list from its CUDA kernels alone (the scan builds
    its own): (items (S,) int32, count () int32), ``items[:count]`` the
    slots :func:`slot_work_list` lists, by its stage counts, the rest
    unwritten.  For the card tests and ``chip_smoke.py``."""
    if not (qidx.is_cuda and offsets.device == qidx.device):
        raise ValueError("the work-list kernel needs qidx and offsets on one CUDA device")
    qidx, offsets = qidx.contiguous(), offsets.contiguous()
    (S, tpl), K = qidx.shape, offsets.shape[0] - 1
    work = torch.empty(S + WORK_EXTRA, dtype=torch.int32, device=qidx.device)
    with torch.cuda.device(qidx.device):
        err = _kernel_lib().sq_slot_work_list_launch(qidx.data_ptr(), offsets.data_ptr(), work.data_ptr(), S, K,
                                                     tpl, torch.cuda.current_stream(qidx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sq slot work-list kernel launch failed: cudaError_t {err}")
    return work[:S], work[S]


def _hot_scratch(H: int, T: int) -> int:
    """int32 words of K7's route "mma" scratch: its slots' qidx, their work
    buffer, each hot entry's count of filled slots."""
    S = -(-T // _MAX_TOKENS) * H
    return S * _MAX_TOKENS + S + WORK_EXTRA + H


def _check_members(members: Optional[torch.Tensor], T: int, H: int, dev: torch.device) -> None:
    if members is not None and (members.dtype != torch.bool or members.shape != (T, H)
                                or not members.is_contiguous() or members.device != dev):
        raise ValueError(f"members must be a contiguous ({T}, {H}) bool tensor on {dev}")


def hot_schedule_kernel(hot_ids: torch.Tensor, offsets: torch.Tensor, T: int,
                        members: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7's slots and work list on route "mma", its launch stopped before
    the scan: (qidx (G*H, 128), items (G*H,), count ()) int32; qidx as
    :func:`hot_member_schedule` (rows of a -1 entry unwritten),
    ``items[:count]`` the slots :func:`slot_work_list` lists with
    ``lmap=hot_ids``, the rest unwritten.  For the card tests and
    ``chip_smoke.py``."""
    if not (hot_ids.is_cuda and offsets.device == hot_ids.device and hot_ids.dtype == offsets.dtype == torch.int32):
        raise ValueError("K7's schedule kernel needs int32 hot_ids and offsets on one CUDA device")
    H = hot_ids.shape[0]
    _check_members(members, T, H, hot_ids.device)
    scratch = torch.empty(_hot_scratch(H, T), dtype=torch.int32, device=hot_ids.device)
    with torch.cuda.device(hot_ids.device):
        err = _kernel_lib().sq_hot_schedule_launch(
            hot_ids.contiguous().data_ptr(), None if members is None else members.data_ptr(),
            offsets.contiguous().data_ptr(), scratch.data_ptr(), H, T,
            torch.cuda.current_stream(hot_ids.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K7 schedule kernel launch failed: cudaError_t {err}")
    S = -(-T // _MAX_TOKENS) * H
    return scratch[: S * _MAX_TOKENS].view(S, _MAX_TOKENS), scratch[S * _MAX_TOKENS : S * (_MAX_TOKENS + 1)], \
        scratch[S * (_MAX_TOKENS + 1)]


def _launch(units: torch.Tensor, offsets: torch.Tensor, qs: torch.Tensor, codes: torch.Tensor,
            r: int, hot: bool, route: Optional[str] = None, members: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch, on the route :func:`scan_plan` picks or ``route`` names
    ("staged" runs the first design beside it).  K6 (``hot`` False):
    ``units`` is qidx (S, tpl), ``qs`` rounded to bf16 (in the kernel on
    route "mma").  K7: ``units`` is hot_ids (H,), fp32 ``qs``, ``members``
    (T, H) bool or None (every token); route "staged" scans every token
    whatever the members."""
    dev = codes.device
    if not all(t.is_cuda and t.device == dev for t in (units, offsets, qs)):
        raise ValueError("sq list scan kernel needs every tensor on one CUDA device")
    T, D = qs.shape
    if codes.dtype != torch.int8 or codes.dim() != 2 or codes.shape[1] != D:
        raise ValueError(f"codes must be (N, {D}) int8, got {tuple(codes.shape)} {codes.dtype}")
    if units.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise ValueError("qidx / hot_ids and offsets must be int32")
    if not codes.is_contiguous() or codes.data_ptr() % 16:
        raise ValueError("sq list scan kernel needs contiguous, 16-byte aligned codes")
    if D not in _SQ_DIMS:
        raise ValueError(f"sq list scan kernel takes sq_dim in {_SQ_DIMS}, got {D}")
    if not 1 <= r <= _MAX_R:
        raise ValueError(f"sq list scan kernel keeps 1..{_MAX_R} rows per token, got r={r}")
    if hot:
        U, tpl, P = units.shape[0], 0, T
        _check_members(members, T, U, dev)
    else:
        (U, tpl), P = units.shape, units.shape[1]
    route = route or scan_plan(D, tpl or _MAX_TOKENS, r)
    if route not in _ROUTES:
        raise ValueError(f"sq list scan route {route!r} is not one of {_ROUTES}")
    K = offsets.shape[0] - 1
    units = units.contiguous()
    offsets = offsets.contiguous()
    # one allocation a launch (the host's time bounds a launch with little
    # work): the rows, the scores as int32 words, then route "mma"'s scratch
    n = U * r * P
    scratch_words = (_hot_scratch(U, T) if hot else U + WORK_EXTRA) if route == "mma" else 0
    buf = torch.empty(2 * n + scratch_words, dtype=torch.int32, device=dev)
    out_r, out_s = buf[:n].view(U, r, P), buf[n : 2 * n].view(torch.float32).view(U, r, P)
    if U == 0 or T == 0:
        return out_s.fill_(float("-inf")), out_r.fill_(-1)
    # K6 rounds qs to bf16, as the TPU kernel rounds qsT (route "mma" as it
    # stages them); K7 keeps fp32 (route "mma" as three bf16 terms)
    q = (qs.to(torch.bfloat16).float() if route == "staged" and not hot else qs.float()).contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if route == "mma" and hot:  # one launch: the slots and work list into the scratch, then the scan
            err = lib.sq_hot_scan_mma_launch(
                units.data_ptr(), None if members is None else members.data_ptr(), buf.data_ptr() + 8 * n,
                offsets.data_ptr(), q.data_ptr(), codes.data_ptr(), out_s.data_ptr(), out_r.data_ptr(),
                U, T, D, r, stream)
        elif route == "mma":  # the work list into the scratch, then the scan
            err = lib.sq_slot_scan_mma_launch(
                units.data_ptr(), buf.data_ptr() + 8 * n, offsets.data_ptr(), q.data_ptr(), codes.data_ptr(),
                out_s.data_ptr(), out_r.data_ptr(), U, K, D, tpl, r, stream)
        else:
            err = lib.sq_list_scan_launch(
                None if hot else units.data_ptr(), units.data_ptr() if hot else None,
                offsets.data_ptr(), q.data_ptr(), codes.data_ptr(), out_s.data_ptr(), out_r.data_ptr(),
                U, K, T, D, tpl, r, int(hot), stream)
    if err != 0:
        raise RuntimeError(f"sq list scan kernel launch failed ({'K7' if hot else 'K6'} route {route}): "
                           f"cudaError_t {err}")
    (hot_route_launches if hot else route_launches)[route].add()
    return out_s, out_r


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def sq_batch_list_scan(qidx: torch.Tensor, offsets: torch.Tensor, qs: torch.Tensor,
                       codes: torch.Tensor, *, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: per filled slot (``qidx[s, 0] >= 0``), list ``s % K`` against the
    slot's tokens, ``qs`` rounded to bf16.  Returns (scores (S, r, tpl)
    fp32, CSR rows (S, r, tpl) int32), -inf / -1 at unfilled entries.  The
    kernel leaves empty slots unwritten: no pair reads them."""
    if _on_cpu(qidx, offsets, qs, codes):
        return sq_batch_list_scan_ref(qidx, offsets, qs, codes, r=r)
    out = _launch(qidx, offsets, qs, codes, r, hot=False)
    sq_batch_list_scan.launches.add()
    return out


def sq_hot_list_scan(hot_ids: torch.Tensor, offsets: torch.Tensor, qs: torch.Tensor,
                     codes: torch.Tensor, *, r: int, members: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: each hot list (``hot_ids`` (H,), -1 none) against its member
    tokens (``members`` (T, H) bool: token t probes hot list h; None: every
    token), fp32 ``qs``.  Returns (scores (H, r, T) fp32, CSR rows (H, r, T)
    int32).  The kernel leaves the entries of a -1 ``hot_ids`` and of
    non-members unwritten: no pair reads them."""
    if _on_cpu(hot_ids, offsets, qs, codes):
        return sq_hot_list_scan_ref(hot_ids, offsets, qs, codes, r=r, members=members)
    out = _launch(hot_ids, offsets, qs, codes, r, hot=True, members=members)
    sq_hot_list_scan.launches.add()
    return out


sq_batch_list_scan.launches = LaunchCounter()
sq_hot_list_scan.launches = LaunchCounter()
#: K6's launches by kernel route
route_launches = {route: LaunchCounter() for route in _ROUTES}
#: K7's launches by kernel route
hot_route_launches = {route: LaunchCounter() for route in _ROUTES}


# ---- back to tokens ----

def probe_batched_postprocess(sched: SlotSchedule, out_s: torch.Tensor, out_r: torch.Tensor,
                              lists: torch.Tensor, depth: int, pair_valid: torch.Tensor,
                              hot: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (token, probed list) pair's ``r`` entries, from its slot or, for
    a hot list, from K7's output; then each token's top-``depth`` over its
    ``nprobe * r`` entries (ties: the earlier entry first, as ``top_k``).
    ``hot`` = (hot_pos (K,) -1 for cold lists, hot_s (H, r, T), hot_r).
    Returns (scores (T, depth) fp32, rows (T, depth) int32), -inf / -1 padded."""
    T, nprobe = lists.shape
    r = out_s.shape[1]
    ps = out_s[sched.slot_of_pair, :, sched.pos_of_pair]                 # (P, r)
    pr = out_r[sched.slot_of_pair, :, sched.pos_of_pair]
    valid = pair_valid
    if hot is not None:
        hot_pos, hot_s, hot_r = hot
        hp = hot_pos[lists.reshape(-1).long()].long()
        is_hot = hp >= 0
        t_flat = torch.arange(T, device=lists.device).repeat_interleave(nprobe)
        hi = hp.clamp(min=0)
        ps = torch.where(is_hot[:, None], hot_s[hi, :, t_flat], ps)
        pr = torch.where(is_hot[:, None], hot_r[hi, :, t_flat], pr)
        valid = valid | is_hot
    ps = ps.masked_fill(~valid[:, None], float("-inf")).view(T, nprobe * r)
    pr = pr.masked_fill(~valid[:, None], -1).view(T, nprobe * r)
    if nprobe * r <= depth:  # nothing to select: pass everything through
        pad = depth - nprobe * r
        return (torch.nn.functional.pad(ps, (0, pad), value=float("-inf")),
                torch.nn.functional.pad(pr, (0, pad), value=-1).int())
    s, i = torch.sort(ps, dim=1, descending=True, stable=True)
    s = s[:, :depth]
    rows = pr.gather(1, i[:, :depth])
    return s, torch.where(torch.isfinite(s), rows, -1).int()


def ranked_mismatch(s_want: torch.Tensor, r_want: torch.Tensor, s_got: torch.Tensor,
                    r_got: torch.Tensor, tol: float,
                    got_at_want: Optional[torch.Tensor] = None,
                    want_at_got: Optional[torch.Tensor] = None) -> Tuple[float, int]:
    """Compare two ranked outputs ``(n, k)``, best first along dim 1 (a
    kernel against its plain version, or the port against the JAX package):
    returns (max |score difference| over finite scores, ids that differ
    away from near ties).  A near tie is a score within ``tol`` of a
    different neighbouring score, whose order a summation-order difference
    may flip; exact ties must resolve alike.  ``got_at_want``, the got
    side's scores of ``r_want``'s ids (or their exact sums, in fp64), where
    given, also makes an exact tie of ``s_want`` a near tie when those two
    scores differ: two different rows whose sums agree only by rounding.
    ``want_at_got``, the want side's scores of ``r_got``'s ids, where given
    with ``got_at_want``, also excuses an entry whose two ids each score
    within ``tol`` of the other side's score at that rank, on the other
    side: a near tie that a run of exact ties on one side carries past its
    neighbours.  Raises when the -inf pattern differs."""
    fin = torch.isfinite(s_want)
    if not torch.equal(fin, torch.isfinite(s_got)):
        raise AssertionError("the -inf pattern differs")
    err = float((s_got[fin] - s_want[fin]).abs().max()) if fin.any() else 0.0
    w = torch.where(fin, s_want, torch.full_like(s_want, -1e30))
    d = (w[:, 1:] - w[:, :-1]).abs()
    near = (d > 0) & (d <= tol)
    if got_at_want is not None:
        g = torch.where(fin, got_at_want, torch.full_like(got_at_want, -1e30))
        near |= (d == 0) & (g[:, 1:] != g[:, :-1])
    amb = torch.zeros_like(fin)
    amb[:, :-1] |= near
    amb[:, 1:] |= near
    if want_at_got is not None:
        amb |= ((want_at_got - s_want).abs() <= tol) & ((got_at_want - s_got).abs() <= tol)
    return err, int((r_got != r_want)[~amb].sum())

