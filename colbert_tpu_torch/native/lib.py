"""ctypes bindings of the port's host runtime, ``csrc/native.cpp``.

Counterpart of ``colbert_tpu/native/lib.py``'s ``ivf_pack``,
``balanced_assign`` and ``pickle_triples``.  The library is built with g++
at first use (``ops/_build.load_host_library``) and loaded with
``ctypes.CDLL``, which releases the interpreter lock for each call.  Each
binding checks shapes and dtypes, sizes its outputs, and turns a negative
return into an exception; a build that fails raises.  Each counts its calls
(``<function>.calls``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from colbert_tpu_torch.ops._build import LaunchCounter, load_host_library

_P = ctypes.c_void_p
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
_SIGNATURES = {
    "ivf_pack": (ctypes.c_int, [_P, _P, _I64, _I32, _I32, _P, _P, _P]),
    "balanced_assign": (ctypes.c_int, [_P, _I64, _I32, _I32, _I32, _P]),
    "pickle_triples": (_I64, [_P, _P, _I64, _I64, _I64, _P, _P, _P, _I64]),
}
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _native() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = load_host_library("native")
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _int32(a, what: str, ndim: int) -> np.ndarray:
    """``a`` as a C-contiguous int32 array of ``ndim`` dimensions; integers
    outside int32 are refused rather than wrapped."""
    a = np.asarray(a)
    if a.ndim != ndim:
        raise ValueError(f"{what} must have {ndim} dimension(s), got shape {a.shape}")
    if a.dtype != np.int32:
        if a.dtype.kind not in "iu":
            raise ValueError(f"{what} must hold integers, got {a.dtype}")
        if a.size and (a.min() < np.iinfo(np.int32).min or a.max() > np.iinfo(np.int32).max):
            raise ValueError(f"{what} holds values outside int32")
    return np.ascontiguousarray(a, np.int32)


def ivf_pack(assignments, codes: np.ndarray, num_lists: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable counting sort of ``codes`` (N, m) uint8 rows by list id.
    Returns ``(perm (N,) int32, offsets (K+1,) int32, codes sorted (N, m) uint8)``."""
    assignments = _int32(assignments, "assignments", 1)
    codes = np.asarray(codes)
    if codes.dtype != np.uint8 or codes.ndim != 2:
        raise ValueError(f"codes must be a 2-D uint8 array, got {codes.dtype} of shape {codes.shape}")
    codes = np.ascontiguousarray(codes)
    n, m = codes.shape
    if assignments.shape[0] != n:
        raise ValueError(f"{assignments.shape[0]} assignments for {n} code rows")
    perm = np.empty(n, np.int32)
    offsets = np.empty(max(num_lists, 0) + 1, np.int32)
    out = np.empty_like(codes)
    lib = _native()
    ivf_pack.calls.add()
    rc = lib.ivf_pack(_ptr(assignments), _ptr(codes), n, num_lists, m, _ptr(perm), _ptr(offsets), _ptr(out))
    if rc == -2:
        raise ValueError(f"ivf_pack: a list id outside [0, {num_lists})")
    if rc != 0:
        raise ValueError(f"ivf_pack failed with code {rc} ({n} rows, {num_lists} lists, width {m})")
    return perm, offsets, out


def balanced_assign(candidates, num_lists: int, cap: int) -> np.ndarray:
    """Capacity-constrained assignment from (N, kc) candidate lists, best
    first: each point takes its first candidate with fewer than ``cap`` rows,
    else spills to the least-filled list (the earliest on a tie).  Returns
    (N,) int32."""
    candidates = _int32(candidates, "candidates", 2)
    n, kc = candidates.shape
    out = np.empty(n, np.int32)
    lib = _native()
    balanced_assign.calls.add()
    rc = lib.balanced_assign(_ptr(candidates), n, kc, num_lists, cap, _ptr(out))
    if rc != 0:
        raise ValueError(f"balanced_assign failed with code {rc} ({n} x {kc} candidates, "
                         f"{num_lists} lists, cap {cap})")
    return out


def pickle_triples(pids, scores, num_pids: int, text_blob: np.ndarray, text_off: np.ndarray) -> np.ndarray:
    """The pickle body of one batch of ``(pid, score, text)`` rows: ``pids``
    (nq, k), -1 padded, and ``scores`` of the same shape, any float dtype
    (written as the double ``float(score)`` is).  ``text_blob`` (uint8) holds
    each passage's prebuilt fragment at ``text_off[p]:text_off[p + 1]``.
    Returns a uint8 array."""
    pids = _int32(pids, "pids", 2)
    scores = np.ascontiguousarray(scores, np.float64)
    if scores.shape != pids.shape:
        raise ValueError(f"scores of shape {scores.shape} for pids of shape {pids.shape}")
    if text_blob.dtype != np.uint8 or text_blob.ndim != 1 or not text_blob.flags.c_contiguous:
        raise ValueError("text_blob must be a contiguous 1-D uint8 array")
    if text_off.dtype != np.int64 or text_off.shape != (num_pids + 1,) or not text_off.flags.c_contiguous:
        raise ValueError(f"text_off must be a contiguous (num_pids + 1,) int64 array, got {text_off.shape}")
    over = pids[pids >= num_pids]
    if over.size:
        raise IndexError(f"pid {int(over[0])} out of range for {num_pids} passages")
    nq, k = pids.shape
    kept = pids[pids >= 0]
    cap = 3 * nq + 14 * kept.size + int((text_off[kept + 1] - text_off[kept]).sum())
    out = np.empty(cap, np.uint8)
    lib = _native()
    pickle_triples.calls.add()
    w = lib.pickle_triples(_ptr(pids), _ptr(scores), nq, k, num_pids, _ptr(text_blob), _ptr(text_off),
                           _ptr(out), cap)
    if w == -3:
        raise IndexError(f"a pid out of range for {num_pids} passages")
    if w < 0:
        raise ValueError(f"pickle_triples failed with code {w} ({nq} x {k} rows, {num_pids} passages)")
    return out[:w]


ivf_pack.calls = LaunchCounter()
balanced_assign.calls = LaunchCounter()
pickle_triples.calls = LaunchCounter()
