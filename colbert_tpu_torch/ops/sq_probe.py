"""Token-major sq probe: the list-window scan (K10) and each token's top-depth.

Counterpart of ``colbert_tpu/ops/sq_probe_pallas.py`` and of the exact
``_probe_topk`` after it in ``colbert_tpu/ops/ivf.py``: for each query
token and each of its probed lists, score every row of the list against
the token's projected query (fp32 query x int8 codes, fp32 sums), then
keep the token's top-``depth`` rows in ``jax.lax.top_k``'s order.  The TPU
kernel streams 32-row aligned, 128-lane packed windows of padded codes
(``pad_codes_for_scan``); the port's kernels (``csrc/sq_token_scan.cu``)
read each window ``[start, start + len)`` of the unpadded CSR codes, so
``pad_codes_for_scan`` has no counterpart.

:func:`sq_window_topk` has two kernel routes, chosen by
:func:`sq_window_topk_plan` and counted in :data:`route_launches`:

* "fused", for every sq_dim the kernel takes and ``depth`` up to
  :data:`FUSED_MAX_DEPTH`: one launch scores each token's real rows and
  selects its exact top-``depth`` on the chip (radix select over
  order-preserving keys in shared memory, then a sort of the survivors),
  so the batch's output is only (T, depth);
* "staged", the first design, for a deeper ``depth`` and on request: K10
  alone (:func:`sq_list_scan`) writes the dense (T, nprobe * cap) scores,
  -inf past each list's end, and :func:`_window_topk` selects in torch, a
  launch per token chunk whose scores stay within ``_SCAN_ELEMS``.

Both score with the same fp32 arithmetic and select by the same rule, so
they agree bit for bit.  Every launch on either route also counts in
``sq_list_scan.launches``, K10's count.

The wrappers run their plain PyTorch version only for tensors on the CPU;
for CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from colbert_tpu_torch.ops._build import LaunchCounter

_SQ_DIMS = (16, 32, 64, 128)
_ROUTES = ("fused", "staged")
_REF_ELEMS = 1 << 24   # code elements per plain-version step
_SCAN_ELEMS = 1 << 28  # dense score slots per token chunk on route "staged" (1 GiB of fp32)
FUSED_MAX_DEPTH = 2048  # route "fused"'s deepest top-depth (its sort in shared memory); mirrored in the .cu


def sq_list_scan_ref(starts: torch.Tensor, lens: torch.Tensor, qs: torch.Tensor, codes: torch.Tensor,
                     *, cap: int) -> torch.Tensor:
    """Plain version of K10 (same contract as :func:`sq_list_scan`)."""
    T, nprobe = starts.shape
    D = qs.shape[1]
    dev = qs.device
    out = torch.full((T, nprobe, cap), float("-inf"), dtype=torch.float32, device=dev)
    n_rows = codes.shape[0]
    if n_rows == 0:
        return out.view(T, nprobe * cap)
    i = torch.arange(cap, device=dev)
    step = max(1, _REF_ELEMS // (nprobe * cap * D))
    for lo in range(0, T, step):
        rows = starts[lo : lo + step].long()[..., None] + i                 # (n, nprobe, cap)
        valid = i < lens[lo : lo + step].long()[..., None]
        c = codes[rows.clamp(0, n_rows - 1)].float()                       # (n, nprobe, cap, D)
        s = torch.einsum("njcd,nd->njc", c, qs[lo : lo + step].float())
        out[lo : lo + step] = s.masked_fill(~valid, float("-inf"))
    return out.view(T, nprobe * cap)


def topk_first(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row of ``scores`` (n, c) fp32, the ``k <= c`` best (scores,
    columns int64), best first, equal scores in ascending column order:
    ``jax.lax.top_k``'s rule, which ``torch.topk`` does not promise.  One
    ``topk`` over unique int64 keys: the score's bits mapped to an order-
    preserving int32 (-0.0 below +0.0, as XLA's ``top_k`` orders them)
    above the complemented column."""
    s = scores.float()
    bits = s.view(torch.int32)
    hi = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    col = torch.arange(s.shape[1], device=s.device)
    _, idx = torch.topk(hi * (1 << 32) + (0xFFFFFFFF - col), k, dim=1)
    return s.gather(1, idx), idx


def _window_topk(scores: torch.Tensor, starts: torch.Tensor, cap: int, depth: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``depth`` of window scores (n, nprobe*cap), slot j*cap + i being
    row ``starts[:, j] + i`` -> (scores, rows int32), -inf / -1 padded."""
    k = min(depth, scores.shape[1])
    s, i = topk_first(scores, k)
    rows = torch.where(torch.isfinite(s), starts.long().gather(1, i // cap) + i % cap, -1).int()
    if k < depth:
        s = torch.nn.functional.pad(s, (0, depth - k), value=float("-inf"))
        rows = torch.nn.functional.pad(rows, (0, depth - k), value=-1)
    return s, rows


def _staged_topk(scan, starts: torch.Tensor, lens: torch.Tensor, qs: torch.Tensor, codes: torch.Tensor,
                 cap: int, depth: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_window_topk`` over ``scan``'s dense scores, tokens in chunks whose
    (tokens, nprobe * cap) scores stay within ``_SCAN_ELEMS``."""
    T, nprobe = starts.shape
    tc = max(1, _SCAN_ELEMS // (nprobe * cap))
    out = [_window_topk(scan(starts[lo : lo + tc], lens[lo : lo + tc], qs[lo : lo + tc], codes, cap=cap),
                        starts[lo : lo + tc], cap, depth)
           for lo in range(0, T, tc)]
    return torch.cat([s for s, _ in out]), torch.cat([r for _, r in out])


def sq_window_topk_ref(starts: torch.Tensor, lens: torch.Tensor, qs: torch.Tensor, codes: torch.Tensor,
                       *, cap: int, depth: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`sq_window_topk`: the plain K10 and
    :func:`_window_topk`."""
    return _staged_topk(sq_list_scan_ref, starts, lens, qs, codes, cap, depth)


def sq_window_topk_plan(sq_dim: int, depth: int) -> str:
    """The token probe's kernel route: "fused" for ``sq_dim`` in (16, 32,
    64, 128) and ``depth`` up to :data:`FUSED_MAX_DEPTH`, "staged" for a
    deeper ``depth``; raises on an sq_dim neither kernel takes."""
    if sq_dim not in _SQ_DIMS:
        raise ValueError(f"sq window kernels take sq_dim in {_SQ_DIMS}, got {sq_dim}")
    return "fused" if 1 <= depth <= FUSED_MAX_DEPTH else "staged"


# ---- the CUDA kernels ----

_lib_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    from colbert_tpu_torch.ops._build import load_library

    lib = load_library("sq_token_scan")
    with _lib_lock:
        if lib.sq_window_scan_launch.argtypes is None:
            lib.sq_window_topk_max_depth.argtypes, lib.sq_window_topk_max_depth.restype = [], ctypes.c_int
            if lib.sq_window_topk_max_depth() != FUSED_MAX_DEPTH:
                raise RuntimeError("csrc/sq_token_scan.cu route fused disagrees with ops/sq_probe.py")
            lib.sq_window_topk_keys_room.argtypes = [ctypes.c_int] * 2
            lib.sq_window_topk_keys_room.restype = ctypes.c_int
            lib.sq_window_topk_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            lib.sq_window_topk_launch.restype = ctypes.c_int
            lib.sq_window_scan_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            lib.sq_window_scan_launch.restype = ctypes.c_int
    return lib


def _check(starts: torch.Tensor, lens: torch.Tensor, qs: torch.Tensor, codes: torch.Tensor, cap: int):
    dev = codes.device
    if not all(t.is_cuda and t.device == dev for t in (starts, lens, qs)):
        raise ValueError("sq window kernels need every tensor on one CUDA device")
    D = qs.shape[1]
    if codes.dtype != torch.int8 or codes.dim() != 2 or codes.shape[1] != D:
        raise ValueError(f"codes must be (N, {D}) int8, got {tuple(codes.shape)} {codes.dtype}")
    if D not in _SQ_DIMS:
        raise ValueError(f"sq window kernels take sq_dim in {_SQ_DIMS}, got {D}")
    if starts.dtype != torch.int32 or lens.dtype != torch.int32 or lens.shape != starts.shape:
        raise ValueError("starts and lens must be int32 of one shape")
    if not codes.is_contiguous() or codes.data_ptr() % 16:
        raise ValueError("sq window kernels need contiguous, 16-byte aligned codes")
    if starts.shape[1] * cap >= 1 << 31:
        raise ValueError(f"nprobe * cap must stay below 2^31, got {starts.shape[1]} * {cap}")


def _launch(starts: torch.Tensor, lens: torch.Tensor, qs: torch.Tensor, codes: torch.Tensor,
            cap: int) -> torch.Tensor:
    """One launch of the staged kernel: dense (T, nprobe * cap) scores."""
    _check(starts, lens, qs, codes, cap)
    dev = codes.device
    T, nprobe = starts.shape
    out = torch.empty((T, nprobe * cap), dtype=torch.float32, device=dev)
    q = qs.float().contiguous()
    starts, lens = starts.contiguous(), lens.contiguous()
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        err = lib.sq_window_scan_launch(
            starts.data_ptr(), lens.data_ptr(), q.data_ptr(), codes.data_ptr(), out.data_ptr(),
            T, nprobe, cap, qs.shape[1], torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sq window scan kernel launch failed: cudaError_t {err}")
    return out


def _launch_fused(starts: torch.Tensor, lens: torch.Tensor, qs: torch.Tensor, codes: torch.Tensor,
                  cap: int, depth: int, keys_cap: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of route "fused".  A token keeps the keys of up to
    ``keys_cap`` real rows in shared memory (default: at most nprobe * cap,
    and what fits while two blocks share an SM) and scores its rows again
    on each pass when it has more; a test or a timing script passes another
    ``keys_cap``."""
    _check(starts, lens, qs, codes, cap)
    if not 1 <= depth <= FUSED_MAX_DEPTH:
        raise ValueError(f"route fused takes depth 1..{FUSED_MAX_DEPTH}, got {depth}")
    dev = codes.device
    T, nprobe = starts.shape
    lib = _kernel_lib()
    if keys_cap is None:
        keys_cap = min(nprobe * cap, lib.sq_window_topk_keys_room(nprobe, depth))
    out_s = torch.empty((T, depth), dtype=torch.float32, device=dev)
    out_r = torch.empty((T, depth), dtype=torch.int32, device=dev)
    q = qs.float().contiguous()
    starts, lens = starts.contiguous(), lens.contiguous()
    with torch.cuda.device(dev):
        err = lib.sq_window_topk_launch(
            starts.data_ptr(), lens.data_ptr(), q.data_ptr(), codes.data_ptr(), out_s.data_ptr(),
            out_r.data_ptr(), T, nprobe, cap, depth, keys_cap, qs.shape[1],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sq window top-k kernel launch failed at nprobe {nprobe}, depth {depth}: "
                           f"cudaError_t {err} (1: the windows' shared memory exceeds a block's)")
    return out_s, out_r


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _count(route: str) -> None:
    sq_list_scan.launches.add()
    route_launches[route].add()


def sq_list_scan(starts: torch.Tensor, lens: torch.Tensor, qs: torch.Tensor, codes: torch.Tensor,
                 *, cap: int) -> torch.Tensor:
    """K10 alone (route "staged"'s kernel): ``starts``/``lens`` (T, nprobe)
    int32 windows of the CSR codes (N, D) int8, ``qs`` (T, D) fp32
    projected queries -> scores (T, nprobe * cap) fp32: slot (t, j*cap + i)
    scores row ``starts[t, j] + i`` for ``i < lens[t, j]`` (at most ``cap``
    rows), -inf elsewhere."""
    if _on_cpu(starts, lens, qs, codes):
        return sq_list_scan_ref(starts, lens, qs, codes, cap=cap)
    out = _launch(starts, lens, qs, codes, cap)
    _count("staged")
    return out


def sq_window_topk(starts: torch.Tensor, lens: torch.Tensor, qs: torch.Tensor, codes: torch.Tensor,
                   *, cap: int, depth: int, route: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's top-``depth`` over its windows: ``starts``/``lens`` (T,
    nprobe) int32 windows of the CSR codes (N, D) int8 (at most ``cap``
    rows each), ``qs`` (T, D) fp32 -> (scores (T, depth) fp32, CSR rows
    (T, depth) int32), best first, -inf / -1 padded.  Equal to
    ``_window_topk(sq_list_scan(...), starts, cap, depth)`` element for
    element: equal scores resolve to the lower column ``j * cap + i`` (the
    lower probe rank, then row), -0.0 below +0.0.  ``route`` (CUDA only):
    "fused" or "staged"; default :func:`sq_window_topk_plan`'s."""
    if route is not None and route not in _ROUTES:
        raise ValueError(f"unknown sq window route {route!r}; routes are {_ROUTES}")
    if _on_cpu(starts, lens, qs, codes):
        return sq_window_topk_ref(starts, lens, qs, codes, cap=cap, depth=depth)
    route = route or sq_window_topk_plan(qs.shape[1], depth)
    if route == "fused":
        out = _launch_fused(starts, lens, qs, codes, cap, depth)
        _count("fused")
        return out
    return _staged_topk(sq_list_scan, starts, lens, qs, codes, cap, depth)


sq_list_scan.launches = LaunchCounter()
#: K10's launches by kernel route
route_launches = {route: LaunchCounter() for route in _ROUTES}
