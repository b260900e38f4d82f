"""Scalar-quantized candidate codec ("sq"): a PCA projection + int8.

Counterpart of ``colbert_tpu/ops/sq.py``.  :func:`sq_train` fits the top
``sq_dim`` eigenvectors of the sample's uncentered covariance and per-dim
int8 scales; :func:`sq_encode` stores rows as int8; :func:`sq_query`
projects and descales queries so that ``codes . sq_query(q) ~= <x, q>``.
All in fp32.  ``eigh`` may return an eigenvector with the opposite sign of
another implementation's; the codes then flip sign in that column.
"""

from __future__ import annotations

from typing import Tuple

import torch


def sq_train(points: torch.Tensor, out_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """points (N, d) -> (proj (d, out_dim) fp32, scales (out_dim,) fp32)."""
    x = points.float()
    cov = (x.T @ x) / x.shape[0]
    _, vecs = torch.linalg.eigh(cov)           # ascending eigenvalues
    proj = vecs.flip(1)[:, :out_dim].contiguous()
    z = x @ proj
    scales = 127.0 / z.abs().amax(dim=0).clamp_min(1e-6)
    return proj, scales


def sq_encode(points: torch.Tensor, proj: torch.Tensor, scales: torch.Tensor,
              chunk: int = 65536) -> torch.Tensor:
    """(N, d) -> int8 codes (N, out_dim): ``clip(round(x @ proj * scales), +-127)``
    (``torch.round`` rounds half to even, as ``jnp.round``)."""
    out = torch.empty((points.shape[0], proj.shape[1]), dtype=torch.int8, device=points.device)
    for lo in range(0, points.shape[0], chunk):
        z = (points[lo : lo + chunk].float() @ proj) * scales
        out[lo : lo + chunk] = torch.round(z).clamp_(-127, 127).to(torch.int8)
    return out


def sq_query(q: torch.Tensor, proj: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Project and descale queries: (T, d) -> (T, out_dim) fp32."""
    return (q.float() @ proj.float()) / scales.float()
