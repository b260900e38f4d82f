"""Fused candidate gather + exact MaxSim rerank over a doc-major table.

Counterpart of ``colbert_tpu/ops/rerank_pallas.py`` for uniform-doclen
(multiview) corpora, where doc ``p`` occupies table rows
``[p*dv, (p+1)*dv)``:

    score[b, c] = sum over query b's views of max over the dv rows of
                  table[row] . Q[b, view]        (-inf where cand[b, c] < 0)

* :func:`maxsim_rerank_uniform` (K4): bf16 table, queries rounded to bf16;
* :func:`maxsim_rerank_uniform_int8` (K5): int8 table (the JAX package's
  table before ``pack_int8_table`` permutes it into 128-lane chunks; the
  port keeps it unpacked), queries in fp32 with the per-dim descale
  ``1/scale`` already multiplied in, as the TPU kernel takes them.

Both run one CUDA kernel (``csrc/rerank.cu``) for CUDA tensors, counted in
their ``launches`` counters, and their plain PyTorch versions (``*_ref``)
for CPU tensors.  Any candidate count works; the JAX kernels need a
multiple of 128.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np
import torch

from colbert_tpu_torch.ops._build import LaunchCounter

_MAX_VIEWS = 32  # query rows; mirrored by rerank_max_views() in the .cu
_REF_BYTES = 1 << 30  # gathered fp32 doc rows per plain-version step


def quantize_emb_table(emb, chunk: int = 1 << 18) -> Tuple[np.ndarray, np.ndarray]:
    """Per-dim symmetric int8 quantization: ``(int8 (N, dim), scale (dim,)
    fp32)`` with ``emb ~= int8 / scale``, ``scale = 127 / max(amax, 1e-6)``,
    ``rint`` and a clip to +-127.  The numpy path of the JAX package's
    ``quantize_emb_table`` (``rerank_pallas.py:241-269``), chunked so a
    large table never has a second fp32 copy."""
    n, dim = emb.shape
    amax = np.zeros(dim, np.float32)
    for lo in range(0, n, chunk):
        c = np.asarray(emb[lo : lo + chunk])
        np.maximum(amax, np.abs(c.astype(np.float32)).max(axis=0), out=amax)
    scale = (127.0 / np.maximum(amax, 1e-6)).astype(np.float32)
    out = np.empty((n, dim), np.int8)
    for lo in range(0, n, chunk):
        x = np.asarray(emb[lo : lo + chunk]).astype(np.float32) * scale
        out[lo : lo + chunk] = np.clip(np.rint(x), -127, 127).astype(np.int8)
    return out, scale


# ---- plain PyTorch versions ----

def _rerank_ref(cand: torch.Tensor, q: torch.Tensor, table: torch.Tensor, dv: int) -> torch.Tensor:
    """fp32 MaxSim of ``q`` (B, qv, dim) fp32 against each candidate's
    block of ``table`` (read as fp32), in candidate chunks that bound the
    gathered transient."""
    B, C = cand.shape
    dim = q.shape[-1]
    docs = table[: (table.shape[0] // dv) * dv].view(-1, dv, dim)
    out = torch.full((B, C), float("-inf"), dtype=torch.float32, device=q.device)
    step = max(1, _REF_BYTES // max(1, B * dv * dim * 4))
    for lo in range(0, C, step):
        c = cand[:, lo : lo + step].long()
        D = docs[c.clamp(min=0)].float()                                   # (B, c, dv, dim)
        sim = torch.einsum("bqh,bcdh->bcqd", q, D)
        s = sim.amax(dim=-1).sum(dim=-1)
        out[:, lo : lo + step] = s.masked_fill(c < 0, float("-inf"))
    return out


def maxsim_rerank_uniform_ref(cand: torch.Tensor, Qm: torch.Tensor, table: torch.Tensor,
                              *, dv: int) -> torch.Tensor:
    """Plain version of K4: queries rounded to bf16, table values in fp32."""
    return _rerank_ref(cand, Qm.to(torch.bfloat16).float(), table, dv)


def maxsim_rerank_uniform_int8_ref(cand: torch.Tensor, Qm: torch.Tensor, table: torch.Tensor,
                                   *, dv: int) -> torch.Tensor:
    """Plain version of K5: fp32 queries (descale folded in), int8 values in fp32."""
    return _rerank_ref(cand, Qm.float(), table, dv)


# ---- the CUDA kernel ----

_lib_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    from colbert_tpu_torch.ops._build import load_library

    lib = load_library("rerank")
    with _lib_lock:
        if lib.rerank_launch.argtypes is None:
            lib.rerank_launch.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            )
            lib.rerank_launch.restype = ctypes.c_int
            lib.rerank_max_views.argtypes, lib.rerank_max_views.restype = [], ctypes.c_int
            if lib.rerank_max_views() != _MAX_VIEWS:
                raise RuntimeError("csrc/rerank.cu limits disagree with ops/rerank.py")
    return lib


def _launch(cand: torch.Tensor, Qm: torch.Tensor, table: torch.Tensor, dv: int,
            table_dtype: torch.dtype) -> torch.Tensor:
    dev = table.device
    if not (cand.is_cuda and Qm.is_cuda and cand.device == Qm.device == dev):
        raise ValueError("rerank kernel needs cand, Qm and table on one CUDA device")
    if table.dtype != table_dtype or table.dim() != 2:
        raise ValueError(f"rerank kernel takes a 2-D {table_dtype} table, got {table.dtype} {tuple(table.shape)}")
    B, qv, dim = Qm.shape
    if cand.dim() != 2 or cand.shape[0] != B or cand.dtype != torch.int32:
        raise ValueError(f"cand must be ({B}, C) int32, got {tuple(cand.shape)} {cand.dtype}")
    if table.shape[1] != dim or dim % 16 or dim < 16:
        raise ValueError(f"rerank kernel needs a table of width {dim}, a multiple of 16")
    if not 1 <= qv <= _MAX_VIEWS:
        raise ValueError(f"rerank kernel takes 1..{_MAX_VIEWS} query views, got {qv}")
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("rerank kernel needs a contiguous, 16-byte aligned table")
    C = cand.shape[1]
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    if B == 0 or C == 0:
        return out
    lib = _kernel_lib()
    cand, q = cand.contiguous(), Qm.float().contiguous()
    with torch.cuda.device(dev):
        err = lib.rerank_launch(cand.data_ptr(), q.data_ptr(), table.data_ptr(),
                                int(table_dtype == torch.int8), out.data_ptr(), B, C, qv, dim, dv,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rerank kernel launch failed: cudaError_t {err} "
                           f"(Q {tuple(Qm.shape)}, table {tuple(table.shape)}, dv {dv})")
    return out


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def maxsim_rerank_uniform(cand: torch.Tensor, Qm: torch.Tensor, table: torch.Tensor,
                          *, dv: int) -> torch.Tensor:
    """K4: exact MaxSim (B, C) fp32 of each candidate pid (-1: -inf, no
    bytes read) against ``Qm`` (B, qv, dim) rounded to bf16, over a bf16
    table (num_docs * dv, dim)."""
    if _on_cpu(cand, Qm, table):
        return maxsim_rerank_uniform_ref(cand, Qm, table, dv=dv)
    out = _launch(cand, Qm, table, dv, torch.bfloat16)
    maxsim_rerank_uniform.launches.add()
    return out


def maxsim_rerank_uniform_int8(cand: torch.Tensor, Qm: torch.Tensor, table: torch.Tensor,
                               *, dv: int) -> torch.Tensor:
    """K5: K4 over an int8 table (num_docs * dv, dim); ``Qm`` stays fp32
    and carries the descale ``1/scale``."""
    if _on_cpu(cand, Qm, table):
        return maxsim_rerank_uniform_int8_ref(cand, Qm, table, dv=dv)
    out = _launch(cand, Qm, table, dv, torch.int8)
    maxsim_rerank_uniform_int8.launches.add()
    return out


maxsim_rerank_uniform.launches = LaunchCounter()
maxsim_rerank_uniform_int8.launches = LaunchCounter()
