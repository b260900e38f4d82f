"""Product quantization: codebook training, encoding and ADC lookups.

Counterpart of ``colbert_tpu/ops/pq.py``.  The vector space splits into
``m`` subspaces of ``dsub = d/m`` dims, each with its own ``ksub``-entry
codebook; all ``m`` Lloyd problems run batched.  Distances are
``||c||^2 - 2 x.c`` over fp32 products, as the JAX package writes them:
unlike :mod:`colbert_tpu_torch.ops.kmeans` there is no bf16 rounding here,
and the products run with TF32 off (PyTorch's default for matmuls).  On a
tie the first codeword wins (``torch.argmin``); a codeword that no point
chose keeps its value.

``jax.random.choice`` cannot be reproduced, so :func:`pq_lloyd` takes the
initial codebooks (a test gives it JAX's own) and :func:`pq_train` draws
them from a ``torch.Generator``.

ADC (asymmetric distance computation): a query builds per-subspace lookup
tables ``lut[m, ksub] = <q_sub, codebook[m, ksub]>``; a code row scores
``sum_j lut[j, code[j]]``.
"""

from __future__ import annotations

from typing import Optional

import torch


def _split(points: torch.Tensor, m: int) -> torch.Tensor:
    n, d = points.shape
    return points.float().reshape(n, m, d // m)


def _nearest(x: torch.Tensor, codebooks: torch.Tensor, c_sq: torch.Tensor) -> torch.Tensor:
    """x (n, m, dsub) -> nearest codeword per subspace (n, m) int64."""
    dots = torch.einsum("nmd,mkd->nmk", x, codebooks)
    return torch.argmin(c_sq[None] - 2.0 * dots, dim=-1)


def pq_lloyd(points: torch.Tensor, codebooks0: torch.Tensor, iters: int, chunk: int = 16384) -> torch.Tensor:
    """``iters`` Lloyd iterations of every subspace from the given initial
    codebooks (m, ksub, dsub) -> (m, ksub, dsub) fp32."""
    cb = codebooks0.float().clone()
    m, ksub, dsub = cb.shape
    x = _split(points, m)
    sub = torch.arange(m, device=cb.device) * ksub
    for _ in range(iters):
        c_sq = (cb * cb).sum(dim=-1)
        sums = torch.zeros((m * ksub, dsub), dtype=torch.float32, device=cb.device)
        counts = torch.zeros((m * ksub,), dtype=torch.float32, device=cb.device)
        for lo in range(0, x.shape[0], chunk):
            xc = x[lo : lo + chunk]
            flat = (_nearest(xc, cb, c_sq) + sub[None, :]).reshape(-1)
            sums.index_add_(0, flat, xc.reshape(-1, dsub))
            counts += torch.bincount(flat, minlength=m * ksub).float()
        sums, counts = sums.view(m, ksub, dsub), counts.view(m, ksub)
        new = sums / counts.clamp_min(1.0)[..., None]
        cb = torch.where((counts > 0)[..., None], new, cb)
    return cb


def pq_train(points: torch.Tensor, m: int, ksub: int = 256, *, iters: int = 25,
             generator: Optional[torch.Generator] = None, chunk: int = 16384) -> torch.Tensor:
    """Train PQ codebooks.  points (N, d) -> codebooks (m, ksub, dsub) fp32.
    The initial codewords are ``ksub`` points drawn from ``generator``
    (distinct, or with replacement when N < ksub)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    x = _split(points, m)
    n = x.shape[0]
    gen_dev = generator.device
    idx = (torch.randint(n, (ksub,), generator=generator, device=gen_dev) if n < ksub
           else torch.randperm(n, generator=generator, device=gen_dev)[:ksub])
    codebooks0 = x[idx.to(x.device)].transpose(0, 1)  # (m, ksub, dsub)
    return pq_lloyd(points, codebooks0, iters, chunk=chunk)


def pq_encode(points: torch.Tensor, codebooks: torch.Tensor, chunk: int = 16384) -> torch.Tensor:
    """Assign codes.  points (N, d), codebooks (m, ksub, dsub) -> (N, m) uint8."""
    cb = codebooks.float()
    m = cb.shape[0]
    c_sq = (cb * cb).sum(dim=-1)
    out = torch.empty((points.shape[0], m), dtype=torch.uint8, device=points.device)
    for lo in range(0, points.shape[0], chunk):
        out[lo : lo + chunk] = _nearest(_split(points[lo : lo + chunk], m), cb, c_sq).to(torch.uint8)
    return out


def pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Reconstruct vectors.  codes (N, m) -> (N, m * dsub)."""
    m, ksub, dsub = codebooks.shape
    sub = torch.arange(m, device=codes.device) * ksub
    flat = codebooks.reshape(m * ksub, dsub)[codes.long() + sub[None, :]]  # (N, m, dsub)
    return flat.reshape(codes.shape[0], m * dsub)


def adc_lut(queries: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Per-query inner-product LUTs.  queries (B, d) -> (B, m, ksub) fp32."""
    m, _, dsub = codebooks.shape
    return torch.einsum("bmd,mkd->bmk", queries.float().reshape(-1, m, dsub), codebooks.float())


def adc_score(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC scores by gather.  lut (B, m, ksub), codes (C, m) -> (B, C) fp32."""
    B, m, ksub = lut.shape
    idx = codes.long() + torch.arange(m, device=codes.device)[None, :] * ksub   # (C, m)
    return lut.reshape(B, m * ksub)[:, idx].sum(dim=-1)


def adc_score_onehot(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC as a one-hot product, as the JAX package's MXU path computes it:
    the LUT rounded to bf16, exact 0/1 weights, fp32 sums.
    lut (B, m, ksub), codes (C, m) -> (B, C)."""
    B, m, ksub = lut.shape
    oh = torch.nn.functional.one_hot(codes.long(), ksub).reshape(codes.shape[0], m * ksub)
    return lut.reshape(B, m * ksub).to(torch.bfloat16).float() @ oh.float().T
