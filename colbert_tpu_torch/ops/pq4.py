"""PQ4 fast-scan: 4-bit product quantization and its list scan (K8).

Counterpart of ``colbert_tpu/ops/pq4.py``.  Codes are ``m`` 4-bit
sub-quantizer indices, packed two to a byte (byte ``jj`` holds
``nib[2jj] | nib[2jj+1] << 4``), so a code row is ``m/2`` bytes.

The probe (:func:`ivf_probe_pq4`) takes each token's exact coarse
top-``nprobe`` lists, builds its ADC lookup table (``m x 16`` entries,
fp32, :func:`~colbert_tpu_torch.ops.pq.adc_lut`), and K8
(:func:`pq4_list_scan`, ``csrc/pq4_scan.cu``) scores every row of each
probed list, ``sum_j bf16(lut[t, j, nib(row, j)])`` in fp32 (the TPU
kernel's LUT is bf16, its one-hot exact), keeping the top ``r`` (score,
CSR row) of each (token, probed list).  Each token then keeps the
top-``depth`` of its ``nprobe * r`` entries.

The TPU layout helpers (``build_pq4_blocks``, ``pq4_meta``: lists re-padded
to 128-row blocks, 128-lane packing, scalar-prefetch metadata) have no
counterpart: the kernel reads each list's rows ``[offsets[l],
offsets[l+1])`` of the CSR codes.  The TPU kernel's 128-row blocks,
counted from each list's start (no 32-row alignment here, unlike K6),
still decide ties: within a block the lowest row wins, a block row beats an
equal score held from an earlier block, and among equal scores the later
block's rows come first.  The selection is therefore the top ``r`` under
the order (score desc, block desc, row asc), and rows equal the JAX
package's wherever scores are not near ties; duplicate code rows, whose
scores are bit-identical, resolve alike.

K8 has two kernel routes in ``csrc/pq4_scan.cu``, chosen by
:func:`pq4_scan_plan` and counted in :data:`route_launches`:

* "onehot", every shape K8 takes: the (token, probe) pairs grouped by
  list into items of up to 64 member tokens, most work first, on the
  device (plain version :func:`pq4_work_list`; no host sync); one block an
  SM scores each item's list once for its members as the TPU kernel does,
  a one-hot product on the tensor cores (the one-hot of each row's nibbles
  built in registers, the members' bf16 LUT streamed through shared
  memory, ``wgmma`` with fp32 accumulation), and takes each token's
  top-``r`` from the score tiles;
* "lookup", K8's first design (one block per token, the LUT in shared
  memory, a lane per row), reached only when asked for
  (``_launch(..., route="lookup")``), so that a run can check and time
  both on one input.

The wrapper runs its plain PyTorch version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises, and counts the launch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from colbert_tpu_torch.ops._build import LaunchCounter
from colbert_tpu_torch.ops.ivf import coarse_lists, topk_first
from colbert_tpu_torch.ops.pq import adc_lut, pq_encode, pq_train

KSUB = 16
BLOCK_ROWS = 128     # the TPU kernel's block: it sets the tie rule
_BPRS = (4, 8, 16, 32, 64, 128)  # bytes per code row the kernel takes
_MAX_R = 16          # mirrored by pq4_scan_max_r() in the .cu
_ROUTES = ("onehot", "lookup")
_REF_ELEMS = 1 << 24  # LUT gathers per plain-version step
ONEHOT_GROUP = 64     # member tokens an item of route "onehot" (csrc: pq4_onehot_group)
WORK_TILE_ROWS = 64   # rows a tile of route "onehot"; the work list orders items by tiles
WORK_TILE_TOKENS = 16
WORK_BUCKETS = 32     # work counts the work list tells apart (larger ones share the last)
WORK_CTL = 3 + 2 * WORK_BUCKETS  # work-buffer control words (csrc: pq4_onehot_work_words(0, 0))


def pq4_train(points: torch.Tensor, m: int, *, iters: int = 25,
              generator: Optional[torch.Generator] = None, chunk: int = 16384) -> torch.Tensor:
    """Codebooks (m, 16, d/m): PQ training at 4 bits."""
    return pq_train(points, m, KSUB, iters=iters, generator=generator, chunk=chunk)


def pq4_encode_packed(points: torch.Tensor, codebooks: torch.Tensor, chunk: int = 16384) -> torch.Tensor:
    """Encode and pack: (N, d) -> int8 (N, m/2), byte jj = nib[2jj] | nib[2jj+1] << 4."""
    codes = pq_encode(points, codebooks, chunk=chunk)  # (N, m) uint8 in [0, 16)
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).view(torch.int8)


def pq4_unpack(packed: torch.Tensor) -> torch.Tensor:
    """(N, m/2) int8 -> (N, m) uint8 nibbles."""
    b = packed.view(torch.uint8)
    return torch.stack([b & 15, b >> 4], dim=2).reshape(b.shape[0], 2 * b.shape[1])


# ---- K8's plain PyTorch version ----

def pq4_list_scan_ref(lists: torch.Tensor, offsets: torch.Tensor, lut: torch.Tensor,
                      codes: torch.Tensor, *, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K8: for each token t and probe j, the top-``r``
    rows of list ``lists[t, j]`` (scores (T, nprobe, r) fp32, CSR rows
    (T, nprobe, r) int32; -inf / -1 unfilled).

    Emulates the TPU kernel's merge: blocks of 128 rows from the list
    start; a block's top-r by a stable sort (the lowest row first among
    ties), merged with the held top-r by a stable sort of [block, held]
    (the block's entries first among ties).  A score is the even
    subspaces' sum plus the odd subspaces' sum of the bf16-rounded LUT."""
    T, nprobe = lists.shape
    m = lut.shape[1]
    dev = lut.device
    U = T * nprobe
    out_s = torch.full((U, r), float("-inf"), dtype=torch.float32, device=dev)
    out_r = torch.full((U, r), -1, dtype=torch.int32, device=dev)
    n_rows = codes.shape[0]
    if n_rows == 0:
        return out_s.view(T, nprobe, r), out_r.view(T, nprobe, r)
    lutb = lut.to(torch.bfloat16).float().reshape(T, m * KSUB)
    sub = torch.arange(m, device=dev) * KSUB
    l_flat = lists.reshape(-1).long()
    t_flat = torch.arange(T, device=dev).repeat_interleave(nprobe)
    lo_all, hi_all = offsets[l_flat].long(), offsets[l_flat + 1].long()
    step = max(1, _REF_ELEMS // (BLOCK_ROWS * m))
    arange = torch.arange(BLOCK_ROWS, device=dev)
    for u0 in range(0, U, step):
        lo, hi = lo_all[u0 : u0 + step], hi_all[u0 : u0 + step]
        n = lo.numel()
        table = lutb[t_flat[u0 : u0 + step]]                               # (n, m*16)
        st_s = torch.full((n, r), float("-inf"), dtype=torch.float32, device=dev)
        st_r = torch.full((n, r), -1, dtype=torch.int64, device=dev)
        for b in range(int(((hi - lo + BLOCK_ROWS - 1) // BLOCK_ROWS).max())):
            rows = lo[:, None] + b * BLOCK_ROWS + arange                  # (n, 128)
            nib = pq4_unpack(codes[rows.clamp(0, n_rows - 1).reshape(-1)]).view(n, BLOCK_ROWS, m)
            g = table.gather(1, (nib.long() + sub).view(n, -1)).view(n, BLOCK_ROWS, m)
            s = g[..., 0::2].sum(dim=-1) + g[..., 1::2].sum(dim=-1)
            s = s.masked_fill(rows >= hi[:, None], float("-inf"))
            bs, bi = torch.sort(s, dim=1, descending=True, stable=True)
            k = min(r, BLOCK_ROWS)
            ms, mi = torch.sort(torch.cat([bs[:, :k], st_s], dim=1), dim=1, descending=True, stable=True)
            st_s, st_r = ms[:, :r], torch.cat([rows.gather(1, bi[:, :k]), st_r], dim=1).gather(1, mi[:, :r])
        out_s[u0 : u0 + step] = st_s
        out_r[u0 : u0 + step] = torch.where(torch.isfinite(st_s), st_r, -1).int()
    return out_s.view(T, nprobe, r), out_r.view(T, nprobe, r)


# ---- route "onehot"'s work list ----

class Pq4WorkList(NamedTuple):
    cnt: torch.Tensor     # (K,) int32 pairs of each list
    lstart: torch.Tensor  # (K,) int32 first index of list l's pairs in `pairs`
    pairs: torch.Tensor   # (T*nprobe,) int32 pair ids t*nprobe + j, grouped by list
    items: torch.Tensor   # (max_items,) int32 an item's first index in `pairs`; items[:count] most work first
    count: torch.Tensor   # () int32 items


def max_items(P: int, K: int) -> int:
    """Items route "onehot" may make of ``P`` pairs over ``K`` lists."""
    return P // ONEHOT_GROUP + min(P, K)


def item_buckets(offsets: torch.Tensor, lists_of_items: torch.Tensor, members: torch.Tensor) -> torch.Tensor:
    """An item's work bucket: its list's 64-row tiles x its 16-token tiles,
    capped at the last bucket."""
    lens = (offsets[1:] - offsets[:-1]).long()[lists_of_items.long()]
    tiles = (lens + WORK_TILE_ROWS - 1) // WORK_TILE_ROWS
    return (tiles * ((members.long() + WORK_TILE_TOKENS - 1) // WORK_TILE_TOKENS)).clamp(max=WORK_BUCKETS - 1)


def pq4_work_list(lists: torch.Tensor, offsets: torch.Tensor) -> Pq4WorkList:
    """Plain version of route "onehot"'s work list (the CUDA source builds
    it on the device).  The T*nprobe (token, probe) pairs grouped by list
    (a stable sort: ascending token within a list; lists in ascending
    order), each list's pairs cut into items of up to 64 members in that
    order, every pair in exactly one item, and the items ordered most work
    first (:func:`item_buckets`; equal buckets in (list, item) order here,
    in the kernel's atomics' order on the card, whose pairs within a list
    and list ranges also follow atomics); ``items`` past ``count`` are -1.
    A list no token probes has no item; an empty list probed by a token has
    one."""
    T, nprobe = lists.shape
    P, K = T * nprobe, offsets.shape[0] - 1
    dev = lists.device
    l_flat = lists.reshape(-1).long()
    cnt = torch.zeros(K, dtype=torch.int64, device=dev).scatter_add_(0, l_flat, torch.ones_like(l_flat))
    lstart = torch.cumsum(cnt, 0) - cnt
    pairs = torch.sort(l_flat, stable=True)[1]
    per_list = (cnt + ONEHOT_GROUP - 1) // ONEHOT_GROUP
    of_item = torch.repeat_interleave(torch.arange(K, device=dev), per_list)
    k = torch.arange(of_item.numel(), device=dev) - (torch.cumsum(per_list, 0) - per_list)[of_item]
    members = torch.clamp(cnt[of_item] - k * ONEHOT_GROUP, max=ONEHOT_GROUP)
    order = torch.sort(item_buckets(offsets, of_item, members), descending=True, stable=True)[1]
    items = torch.full((max_items(P, K),), -1, dtype=torch.int32, device=dev)
    items[: order.numel()] = (lstart[of_item] + k * ONEHOT_GROUP)[order].int()
    return Pq4WorkList(cnt.int(), lstart.int(), pairs.int(), items,
                       torch.tensor(order.numel(), dtype=torch.int32, device=dev))


def pq4_scan_plan(m: int, r: int) -> str:
    """K8's kernel route for ``m`` subspaces and ``r`` rows a (token,
    list): "onehot" for every shape K8 takes (``m / 2`` in 4, 8, 16, 32, 64,
    128 bytes a row; ``r`` 1..16); raises on any other."""
    if m % 2 or m // 2 not in _BPRS:
        raise ValueError(f"pq4 list scan kernel takes m/2 in {_BPRS} bytes per row, got m={m}")
    if not 1 <= r <= _MAX_R:
        raise ValueError(f"pq4 list scan kernel keeps 1..{_MAX_R} rows per (token, list), got r={r}")
    return "onehot"


# ---- K8, the CUDA kernels ----

_lib_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    from colbert_tpu_torch.ops._build import load_library

    lib = load_library("pq4_scan")
    with _lib_lock:
        if lib.pq4_scan_launch.argtypes is None:
            lib.pq4_scan_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            lib.pq4_scan_launch.restype = ctypes.c_int
            lib.pq4_onehot_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            lib.pq4_onehot_launch.restype = ctypes.c_int
            lib.pq4_work_list_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            lib.pq4_work_list_launch.restype = ctypes.c_int
            lib.pq4_onehot_work_words.argtypes = [ctypes.c_int] * 2
            lib.pq4_onehot_work_words.restype = ctypes.c_longlong
            for fn in (lib.pq4_scan_max_r, lib.pq4_onehot_group, lib.pq4_work_buckets):
                fn.argtypes, fn.restype = [], ctypes.c_int
            if (lib.pq4_scan_max_r(), lib.pq4_onehot_group(), lib.pq4_work_buckets(),
                    lib.pq4_onehot_work_words(0, 0)) != (_MAX_R, ONEHOT_GROUP, WORK_BUCKETS, WORK_CTL):
                raise RuntimeError("csrc/pq4_scan.cu limits disagree with ops/pq4.py")
    return lib


def _work_words(P: int, K: int) -> int:
    return 3 * K + WORK_CTL + P + max_items(P, K)


def _work_list_view(work: torch.Tensor, P: int, K: int) -> Pq4WorkList:
    """The work buffer's parts (csrc: oh::work_of): cnt, fill, control words
    (the item count first), lstart, pairs, items."""
    c, ls, pa = 2 * K, 2 * K + WORK_CTL, 3 * K + WORK_CTL
    return Pq4WorkList(work[:K], work[ls:pa], work[pa : pa + P], work[pa + P :], work[c])


def work_list_kernel(lists: torch.Tensor, offsets: torch.Tensor) -> Pq4WorkList:
    """Route "onehot"'s work list from its CUDA kernels alone (the scan
    builds its own): what :func:`pq4_work_list` computes, but each list's
    range of ``pairs``, its pairs' order within it and the order of items
    within a bucket follow atomics; ``items`` past ``count`` are unwritten.
    For the card tests and ``chip_smoke.py``."""
    if not (lists.is_cuda and offsets.device == lists.device):
        raise ValueError("the pq4 work-list kernel needs lists and offsets on one CUDA device")
    if lists.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise ValueError("lists and offsets must be int32")
    lists, offsets = lists.contiguous(), offsets.contiguous()
    P, K = lists.numel(), offsets.shape[0] - 1
    work = torch.empty(_work_words(P, K), dtype=torch.int32, device=lists.device)
    with torch.cuda.device(lists.device):
        err = _kernel_lib().pq4_work_list_launch(lists.data_ptr(), offsets.data_ptr(), work.data_ptr(), P, K,
                                                 torch.cuda.current_stream(lists.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pq4 work-list kernel launch failed: cudaError_t {err}")
    return _work_list_view(work, P, K)


def _launch(lists: torch.Tensor, offsets: torch.Tensor, lut: torch.Tensor, codes: torch.Tensor,
            r: int, route: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch on the route :func:`pq4_scan_plan` picks, or on ``route``
    ("lookup" runs the first design beside it)."""
    dev = codes.device
    if not all(t.is_cuda and t.device == dev for t in (lists, offsets, lut)):
        raise ValueError("pq4 list scan kernel needs every tensor on one CUDA device")
    T, nprobe = lists.shape
    m = lut.shape[1]
    if lut.dim() != 3 or lut.shape[0] != T or lut.shape[2] != KSUB:
        raise ValueError(f"lut must be (T, m, {KSUB}), got {tuple(lut.shape)}")
    if codes.dtype != torch.int8 or codes.dim() != 2 or codes.shape[1] * 2 != m:
        raise ValueError(f"codes must be (N, {m // 2}) int8, got {tuple(codes.shape)} {codes.dtype}")
    plan = pq4_scan_plan(m, r)  # raises on a shape K8 does not take, whichever route
    route = route or plan
    if route not in _ROUTES:
        raise ValueError(f"pq4 list scan route {route!r} is not one of {_ROUTES}")
    if lists.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise ValueError("lists and offsets must be int32")
    if not codes.is_contiguous() or codes.data_ptr() % 16:
        raise ValueError("pq4 list scan kernel needs contiguous, 16-byte aligned codes")
    lists, offsets = lists.contiguous(), offsets.contiguous()
    K = offsets.shape[0] - 1
    out_s = torch.empty((T, nprobe, r), dtype=torch.float32, device=dev)
    out_r = torch.empty((T, nprobe, r), dtype=torch.int32, device=dev)
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if route == "onehot":  # the TPU kernel's bf16 LUT; the work list is built in `work`
            table = lut.to(torch.bfloat16).contiguous()
            work = torch.empty(_work_words(T * nprobe, K), dtype=torch.int32, device=dev)
            err = lib.pq4_onehot_launch(
                lists.data_ptr(), offsets.data_ptr(), table.data_ptr(), codes.data_ptr(), work.data_ptr(),
                out_s.data_ptr(), out_r.data_ptr(), T, nprobe, K, codes.shape[1], r, stream)
        else:  # the bf16 LUT held in fp32
            table = lut.to(torch.bfloat16).float().contiguous()
            err = lib.pq4_scan_launch(
                lists.data_ptr(), offsets.data_ptr(), table.data_ptr(), codes.data_ptr(),
                out_s.data_ptr(), out_r.data_ptr(), T, nprobe, codes.shape[1], r, stream)
    if err != 0:
        raise RuntimeError(f"pq4 list scan kernel launch failed ({route}): cudaError_t {err}")
    route_launches[route].add()
    return out_s, out_r


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def pq4_list_scan(lists: torch.Tensor, offsets: torch.Tensor, lut: torch.Tensor, codes: torch.Tensor,
                  *, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: ``lists`` (T, nprobe) int32 probed list ids, ``offsets`` (K+1,)
    int32, ``lut`` (T, m, 16) fp32 (rounded to bf16 here), ``codes`` (N,
    m/2) int8 packed CSR codes -> the top-``r`` (scores (T, nprobe, r)
    fp32, CSR rows (T, nprobe, r) int32) of each (token, probed list),
    best first, -inf / -1 unfilled (an empty list yields only those)."""
    if _on_cpu(lists, offsets, lut, codes):
        return pq4_list_scan_ref(lists, offsets, lut, codes, r=r)
    out = _launch(lists, offsets, lut, codes, r)
    pq4_list_scan.launches.add()
    return out


pq4_list_scan.launches = LaunchCounter()
#: K8's launches by kernel route
route_launches = {route: LaunchCounter() for route in _ROUTES}


# ---- the probe ----

def ivf_probe_pq4(
    q_tokens: torch.Tensor,          # (T, d)
    coarse_centroids: torch.Tensor,  # (K, d)
    codebooks: torch.Tensor,         # (m, 16, d/m)
    codes: torch.Tensor,             # (N, m/2) int8, CSR-sorted by list
    offsets: torch.Tensor,           # (K+1,) int32
    *,
    nprobe: int,
    depth: int,
    r: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PQ4 probe (``colbert_tpu/ops/pq4.py:275``): per token the
    top-``depth`` (scores (T, depth) fp32, CSR rows (T, depth) int32, -inf
    / -1 padded) over the top-``r`` rows of each of its ``nprobe`` lists
    (ties: the earlier (list, entry) first, as ``top_k``).  The coarse
    top-``nprobe`` is exact; the JAX package takes ``approx_max_k`` on a
    TPU."""
    T = q_tokens.shape[0]
    lists = coarse_lists(q_tokens, coarse_centroids, nprobe)
    s, rows = pq4_list_scan(lists.int(), offsets, adc_lut(q_tokens, codebooks), codes, r=r)
    ps, pr = s.view(T, nprobe * r), rows.view(T, nprobe * r)
    if nprobe * r <= depth:  # nothing to select: pass everything through
        pad = depth - nprobe * r
        return (torch.nn.functional.pad(ps, (0, pad), value=float("-inf")),
                torch.nn.functional.pad(pr, (0, pad), value=-1))
    s, i = topk_first(ps, depth)
    return s, torch.where(torch.isfinite(s), pr.gather(1, i), -1).int()
