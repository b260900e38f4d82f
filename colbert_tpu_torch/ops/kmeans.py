"""K-means for the IVF coarse quantizer: Lloyd iterations in chunks.

Counterpart of ``colbert_tpu/ops/kmeans.py``.  Distances are
``||c||^2 - 2 x.c`` (``||x||^2`` is constant per point) with the product
taken over bf16-rounded operands and accumulated in fp32, as the JAX
package does on the MXU: here ``x.bfloat16().float() @ c.bfloat16().float().T``
in fp32, exact per product (a product of two bf16 values fits in fp32), so
only the order of summation differs.  Per-cluster sums are a scatter-add of
the bf16-rounded points in fp32; an empty cluster keeps its centroid.

Initialisation draws from an explicit ``torch.Generator``: random distinct
points above 1,024 centroids, k-means++ (D^2) seeding at or below, as the
JAX package's ``init="auto"``.  Its ``jax.random`` stream cannot be
reproduced, so :func:`lloyd` takes the initial centroids for a test to give
it JAX's own.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _dots(x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """bf16-rounded x times bf16-rounded centroids ``cb`` (already rounded, (k, d)), fp32."""
    return _bf16(x) @ cb.T


def assign_clusters(points: torch.Tensor, centroids: torch.Tensor, chunk: int = 16384) -> torch.Tensor:
    """argmin_c ||x - c||^2 per point (the first on a tie) -> (N,) int32."""
    c = centroids.float()
    c_sq = (c * c).sum(dim=-1)
    cb = _bf16(c)
    out = torch.empty(points.shape[0], dtype=torch.int32, device=points.device)
    for lo in range(0, points.shape[0], chunk):
        d = c_sq[None, :] - 2.0 * _dots(points[lo : lo + chunk], cb)
        out[lo : lo + chunk] = torch.argmin(d, dim=-1).int()
    return out


def nearest_centroids(points: torch.Tensor, centroids: torch.Tensor, kc: int,
                      chunk: int = 16384) -> torch.Tensor:
    """Top-``kc`` nearest centroid ids per point, best first -> (N, kc) int32."""
    c = centroids.float()
    c_sq = (c * c).sum(dim=-1)
    cb = _bf16(c)
    out = torch.empty((points.shape[0], kc), dtype=torch.int32, device=points.device)
    for lo in range(0, points.shape[0], chunk):
        _, idx = torch.topk(2.0 * _dots(points[lo : lo + chunk], cb) - c_sq[None, :], kc, dim=-1)
        out[lo : lo + chunk] = idx.int()
    return out


def kmeans_plusplus_init(points: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """D^2 seeding: the first centroid uniform, each next one drawn with
    probability proportional to its squared distance to the nearest chosen."""
    x = points.float()
    n = x.shape[0]
    gen_dev = generator.device
    first = int(torch.randint(n, (1,), generator=generator, device=gen_dev))
    chosen = [first]
    min_d2 = torch.full((n,), float("inf"), device=x.device)
    last = x[first]
    for _ in range(k - 1):
        min_d2 = torch.minimum(min_d2, ((x - last[None, :]) ** 2).sum(dim=-1))
        probs = (min_d2 / min_d2.sum().clamp_min(1e-30)).clamp_min(1e-30)
        nxt = int(torch.multinomial(probs.to(gen_dev), 1, generator=generator))
        chosen.append(nxt)
        last = x[nxt]
    return x[torch.tensor(chosen, device=x.device)]


def lloyd(points: torch.Tensor, centroids: torch.Tensor, iters: int, chunk: int = 16384) -> torch.Tensor:
    """``iters`` Lloyd iterations from the given initial centroids -> (k, d) fp32."""
    c = centroids.float().clone()
    k, d = c.shape
    for _ in range(iters):
        c_sq = (c * c).sum(dim=-1)
        cb = _bf16(c)
        sums = torch.zeros((k, d), dtype=torch.float32, device=c.device)
        counts = torch.zeros((k,), dtype=torch.float32, device=c.device)
        for lo in range(0, points.shape[0], chunk):
            x = points[lo : lo + chunk]
            a = torch.argmin(c_sq[None, :] - 2.0 * _dots(x, cb), dim=-1)
            sums.index_add_(0, a, _bf16(x))
            counts += torch.bincount(a, minlength=k).float()
        new = sums / counts.clamp_min(1.0)[:, None]
        c = torch.where((counts > 0)[:, None], new, c)
    return c


def kmeans(points: torch.Tensor, k: int, *, iters: int = 20, generator: Optional[torch.Generator] = None,
           chunk: int = 16384, init: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means -> (centroids (k, d) fp32, assignment (N,) int32).

    ``init``: "random" (distinct random points; with replacement when
    N < k), "kmeans++", or "auto" (k-means++ up to 1,024 clusters, random
    above)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    x = points.float()
    n = x.shape[0]
    if init == "auto":
        init = "kmeans++" if k <= 1024 else "random"
    if init == "random":
        gen_dev = generator.device
        idx = (torch.randint(n, (k,), generator=generator, device=gen_dev) if n < k
               else torch.randperm(n, generator=generator, device=gen_dev)[:k])
        c0 = x[idx.to(x.device)]
    elif init == "kmeans++":
        c0 = kmeans_plusplus_init(x, k, generator)
    else:
        raise ValueError(f"kmeans init must be 'auto', 'random' or 'kmeans++', got {init!r}")
    c = lloyd(x, c0, iters, chunk=chunk)
    return c, assign_clusters(x, c, chunk=chunk)
