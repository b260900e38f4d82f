"""Token-major sq list-window scan (K10).

Counterpart of ``colbert_tpu/ops/sq_probe_pallas.py``: for each query token
and each of its probed lists, score every row of the list against the
token's projected query (fp32 query x int8 codes, fp32 sums).  The TPU
kernel streams 32-row aligned, 128-lane packed windows of padded codes
(``pad_codes_for_scan``); the port's kernel (``csrc/sq_token_scan.cu``)
reads each window ``[start, start + len)`` of the unpadded CSR codes, so
``pad_codes_for_scan`` has no counterpart.  :func:`ivf_probe_sq
<colbert_tpu_torch.ops.ivf.ivf_probe_sq>` takes each token's top-``depth``
of the scores.

The wrapper runs its plain PyTorch version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises, and counts the launch.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from colbert_tpu_torch.ops._build import LaunchCounter

_SQ_DIMS = (16, 32, 64, 128)
_REF_ELEMS = 1 << 24  # code elements per plain-version step


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


_lib_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    from colbert_tpu_torch.ops._build import load_library

    lib = load_library("sq_token_scan")
    with _lib_lock:
        if lib.sq_window_scan_launch.argtypes is None:
            lib.sq_window_scan_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            lib.sq_window_scan_launch.restype = ctypes.c_int
    return lib


def _launch(starts: torch.Tensor, lens: torch.Tensor, qs: torch.Tensor, codes: torch.Tensor,
            cap: int) -> torch.Tensor:
    dev = codes.device
    if not all(t.is_cuda and t.device == dev for t in (starts, lens, qs)):
        raise ValueError("sq window scan kernel needs every tensor on one CUDA device")
    T, nprobe = starts.shape
    D = qs.shape[1]
    if codes.dtype != torch.int8 or codes.dim() != 2 or codes.shape[1] != D:
        raise ValueError(f"codes must be (N, {D}) int8, got {tuple(codes.shape)} {codes.dtype}")
    if D not in _SQ_DIMS:
        raise ValueError(f"sq window scan kernel takes sq_dim in {_SQ_DIMS}, got {D}")
    if starts.dtype != torch.int32 or lens.dtype != torch.int32 or lens.shape != starts.shape:
        raise ValueError("starts and lens must be int32 of one shape")
    if not codes.is_contiguous() or codes.data_ptr() % 16:
        raise ValueError("sq window scan kernel needs contiguous, 16-byte aligned codes")
    out = torch.empty((T, nprobe * cap), dtype=torch.float32, device=dev)
    q = qs.float().contiguous()
    starts, lens = starts.contiguous(), lens.contiguous()
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        err = lib.sq_window_scan_launch(
            starts.data_ptr(), lens.data_ptr(), q.data_ptr(), codes.data_ptr(), out.data_ptr(),
            T, nprobe, cap, D, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sq window scan kernel launch failed: cudaError_t {err}")
    return out


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def sq_list_scan(starts: torch.Tensor, lens: torch.Tensor, qs: torch.Tensor, codes: torch.Tensor,
                 *, cap: int) -> torch.Tensor:
    """K10: ``starts``/``lens`` (T, nprobe) int32 windows of the CSR codes
    (N, D) int8, ``qs`` (T, D) fp32 projected queries -> scores (T, nprobe
    * cap) fp32: slot (t, j*cap + i) scores row ``starts[t, j] + i`` for
    ``i < lens[t, j]`` (at most ``cap`` rows), -inf elsewhere."""
    if _on_cpu(starts, lens, qs, codes):
        return sq_list_scan_ref(starts, lens, qs, codes, cap=cap)
    out = _launch(starts, lens, qs, codes, cap)
    sq_list_scan.launches.add()
    return out


sq_list_scan.launches = LaunchCounter()
