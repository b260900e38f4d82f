"""All-pairs MaxSim late-interaction scoring (K3).

Counterpart of ``colbert_tpu/ops/maxsim.py``.  Semantics match the
reference exactly:

    D = D * d_mask[..., None]; Q = Q * q_mask[..., None]
    score[q, d] = sum over m of  max over n of  <Q[q, m], D[d, n]>

Masked positions are *zeroed before* the max, not set to -inf: a document
whose valid similarities are all negative scores 0 from its masked rows.

* :func:`maxsim_ref` is the plain version of ``maxsim_xla``: a torch einsum,
  differentiable; the train step scores with it.
* :func:`maxsim` launches the CUDA kernel (``csrc/maxsim.cu``, counted in
  ``maxsim.launches``) for CUDA tensors and runs the plain version for CPU
  tensors; the trainer's eval step calls it.  The kernel has two routes,
  chosen by :func:`maxsim_plan` and counted in :data:`route_launches`:
  "tf32" for 16 query rows, 16 doc rows and ``h`` a multiple of 4 (the
  multiview eval shape): fp32 agreement from three TF32 tensor-core
  products (:func:`tf32_split`), the MaxSim in registers; "staged" (the
  first design, fp32 FMA tiles) for every other shape, and on request
  (``_launch(..., route="staged")``), so that a run can check and time both.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from colbert_tpu_torch.ops._build import LaunchCounter

_ROUTES = ("tf32", "staged")
_TF32_VIEWS = 16  # query and doc rows route "tf32" takes; mirrored by maxsim_tf32_views() in the .cu


def _apply_masks(Q: torch.Tensor, D: torch.Tensor, q_mask: Optional[torch.Tensor],
                 d_mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    if q_mask is not None:
        Q = Q * q_mask[..., None].to(Q.dtype)
    if d_mask is not None:
        D = D * d_mask[..., None].to(D.dtype)
    return Q, D


def maxsim_ref(Q: torch.Tensor, D: torch.Tensor, q_mask: Optional[torch.Tensor] = None,
               d_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All-pairs MaxSim, Q (nq, m, h) and D (nd, n, h) -> (nq, nd) fp32.

    ``amax`` splits the gradient evenly between tied maxima, as JAX's max does."""
    Q, D = _apply_masks(Q, D, q_mask, d_mask)
    sim = torch.einsum("qmh,dnh->qdmn", Q.float(), D.float())
    return sim.amax(dim=-1).sum(dim=-1)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route "tf32"'s split of fp32 ``x``, as the kernel makes it
    (``cvt.rna.tf32.f32``: round to nearest, ties away from zero, to 10
    mantissa bits): (hi, lo) fp32 with hi = tf32(x), lo = tf32(x - hi).  A
    product of two TF32 values is exact in fp32, and hi.hi + hi.lo + lo.hi
    is x.y but for ~2^-22 of it."""
    def tf32(v: torch.Tensor) -> torch.Tensor:
        return ((v.float().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def maxsim_plan(m: int, n: int, h: int) -> str:
    """K3's kernel route: "tf32" for ``m`` = ``n`` = 16 and ``h`` a multiple
    of 4, "staged" for every other shape."""
    return "tf32" if m == n == _TF32_VIEWS and h % 4 == 0 and h > 0 else "staged"


# ---- the CUDA kernel ----

_lib_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    from colbert_tpu_torch.ops._build import load_library

    lib = load_library("maxsim")
    with _lib_lock:
        if lib.maxsim_launch.argtypes is None:
            lib.maxsim_tf32_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            lib.maxsim_tf32_launch.restype = ctypes.c_int
            lib.maxsim_tf32_views.argtypes, lib.maxsim_tf32_views.restype = [], ctypes.c_int
            if lib.maxsim_tf32_views() != _TF32_VIEWS:
                raise RuntimeError("csrc/maxsim.cu route tf32 disagrees with ops/maxsim.py")
            lib.maxsim_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            lib.maxsim_launch.restype = ctypes.c_int
    return lib


def _launch(Q: torch.Tensor, D: torch.Tensor, route: Optional[str] = None) -> torch.Tensor:
    """One launch on the route :func:`maxsim_plan` picks or ``route`` names."""
    if not (Q.is_cuda and D.is_cuda and Q.device == D.device):
        raise ValueError(f"maxsim kernel needs Q and D on one CUDA device, got {Q.device} and {D.device}")
    if Q.dtype != torch.float32 or D.dtype != torch.float32:
        raise ValueError(f"maxsim kernel takes float32 Q and D, got {Q.dtype} and {D.dtype}")
    if Q.dim() != 3 or D.dim() != 3 or Q.shape[2] != D.shape[2]:
        raise ValueError(f"maxsim kernel needs Q (nq, m, h) and D (nd, n, h), got {tuple(Q.shape)}, {tuple(D.shape)}")
    nq, m, h = Q.shape
    nd, n, _ = D.shape
    out = torch.empty((nq, nd), dtype=torch.float32, device=Q.device)
    if nq == 0 or nd == 0:
        return out
    if m == 0 or n == 0 or h == 0:
        return out.zero_()
    route = route or maxsim_plan(m, n, h)
    if route not in _ROUTES or (route == "tf32" and maxsim_plan(m, n, h) != "tf32"):
        raise ValueError(f"maxsim route {route!r} does not take Q {tuple(Q.shape)}, D {tuple(D.shape)}")
    lib = _kernel_lib()
    Qc, Dc = Q.contiguous(), D.contiguous()
    if route == "tf32":  # 16-byte cp.async copies
        Qc, Dc = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (Qc, Dc))
    stream = torch.cuda.current_stream(Q.device).cuda_stream
    with torch.cuda.device(Q.device):
        if route == "tf32":
            err = lib.maxsim_tf32_launch(Qc.data_ptr(), Dc.data_ptr(), out.data_ptr(), nq, nd, h, stream)
        else:
            err = lib.maxsim_launch(Qc.data_ptr(), Dc.data_ptr(), out.data_ptr(), nq, m, nd, n, h, stream)
    if err != 0:
        raise RuntimeError(f"maxsim kernel launch failed (route {route}) for Q {tuple(Q.shape)}, D "
                           f"{tuple(D.shape)}: cudaError_t {err} (1: a query's rows exceed a block, or the "
                           f"docs its grid)")
    route_launches[route].add()
    return out


def maxsim(Q: torch.Tensor, D: torch.Tensor, q_mask: Optional[torch.Tensor] = None,
           d_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All-pairs MaxSim, Q (nq, m, h) and D (nd, n, h) fp32 -> (nq, nd) fp32.

    The kernel for CUDA tensors; the plain version for CPU tensors.  Not
    differentiable: training scores with :func:`maxsim_ref`."""
    if Q.device.type == "cpu" and D.device.type == "cpu":
        return maxsim_ref(Q, D, q_mask, d_mask)
    Q, D = _apply_masks(Q, D, q_mask, d_mask)
    out = _launch(Q, D)
    maxsim.launches.add()
    return out


maxsim.launches = LaunchCounter()
#: K3's launches by kernel route
route_launches = {route: LaunchCounter() for route in _ROUTES}
