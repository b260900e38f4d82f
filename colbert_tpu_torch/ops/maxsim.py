"""All-pairs MaxSim late-interaction scoring (K3).

Counterpart of ``colbert_tpu/ops/maxsim.py``.  Semantics match the
reference exactly:

    D = D * d_mask[..., None]; Q = Q * q_mask[..., None]
    score[q, d] = sum over m of  max over n of  <Q[q, m], D[d, n]>

Masked positions are *zeroed before* the max, not set to -inf: a document
whose valid similarities are all negative scores 0 from its masked rows.

* :func:`maxsim_ref` is the plain version of ``maxsim_xla``: a torch einsum,
  differentiable; the train step scores with it.
* :func:`maxsim` launches the CUDA kernel (``csrc/maxsim.cu``, fp32
  products, counted in ``maxsim.launches``) for CUDA tensors and runs the
  plain version for CPU tensors; the trainer's eval step calls it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from colbert_tpu_torch.ops._build import LaunchCounter

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


# ---- the CUDA kernel ----

_lib_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    from colbert_tpu_torch.ops._build import load_library

    lib = load_library("maxsim")
    with _lib_lock:
        if lib.maxsim_launch.argtypes is None:
            lib.maxsim_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            lib.maxsim_launch.restype = ctypes.c_int
    return lib


def _launch(Q: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
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
    lib = _kernel_lib()
    Qc, Dc = Q.contiguous(), D.contiguous()
    with torch.cuda.device(Q.device):
        err = lib.maxsim_launch(Qc.data_ptr(), Dc.data_ptr(), out.data_ptr(), nq, m, nd, n, h,
                                torch.cuda.current_stream(Q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"maxsim kernel launch failed for Q {tuple(Q.shape)}, D {tuple(D.shape)}: "
                           f"cudaError_t {err} (1: a query's rows exceed a block, or the docs its grid)")
    maxsim.launches.add()
    return out


def maxsim(Q: torch.Tensor, D: torch.Tensor, q_mask: Optional[torch.Tensor] = None,
           d_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All-pairs MaxSim, Q (nq, m, h) and D (nd, n, h) fp32 -> (nq, nd) fp32.

    The kernel for CUDA tensors; the plain version for CPU tensors.  Not
    differentiable: training scores with :func:`maxsim_ref`."""
    if Q.device.type == "cpu" and D.device.type == "cpu":
        return maxsim_ref(Q, D, q_mask, d_mask)
    Q, D = _apply_masks(Q, D, q_mask, d_mask)
    return _launch(Q, D)


maxsim.launches = LaunchCounter()
