"""All-pairs MaxSim (K3) of the port against the JAX package.

On CPU tensors ``colbert_tpu_torch.ops.maxsim.maxsim`` runs its plain
version; it is held to ``maxsim_xla`` and to the Pallas kernel
``maxsim_pallas`` in interpret mode, on the same seeded fp32 inputs (unit
rows), within 1e-5: both sides compute fp32 products and differ only in
summation order (``tests/conftest.py`` sets XLA's matmuls to full fp32).
So is a plain emulation of the CUDA kernel's route "tf32" (each fp32 input
split into two TF32 terms, three products, fp32 sums), within 1e-5: the
terms it drops are ~2^-22 of a product.  The CUDA kernel itself is tested
on the card (``tests/test_torch_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.ops.maxsim import maxsim_pallas, maxsim_xla
from colbert_tpu_torch.ops import maxsim as ms

ATOL = 1e-5


def _inputs(seed, nq, m, nd, n, h, negative_docs=0):
    rng = np.random.default_rng(seed)
    unit = lambda *s: (lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True))(rng.normal(size=s)).astype(np.float32)
    Q, D = unit(nq, m, h), unit(nd, n, h)
    q_mask = (rng.random((nq, m)) < 0.8).astype(np.int32)
    d_mask = (rng.random((nd, n)) < 0.7).astype(np.int32)
    d_mask[:, 0] = 1
    for d in range(negative_docs):  # every valid similarity negative: masked rows' 0 wins the max
        D[d] = -np.abs(D[d])
        d_mask[d, -1] = 0
    Q = np.abs(Q) if negative_docs else Q
    return Q, D, q_mask, d_mask


# (nq, m, nd, n, h): multiview n=16, n=64, a ragged doc count, all-negative docs,
# one-row queries and docs, more query rows than the kernel's 64-row chunk with odd h
CASES = [(4, 16, 21, 16, 128), (3, 8, 9, 64, 64), (5, 16, 131, 16, 32), (2, 4, 6, 16, 16),
         (3, 1, 70, 1, 8), (3, 70, 11, 5, 33)]


@pytest.mark.parametrize("nq,m,nd,n,h", CASES)
def test_maxsim_matches_xla(nq, m, nd, n, h):
    Q, D, qm, dm = _inputs(nq * nd, nq, m, nd, n, h, negative_docs=3 if nq == 2 else 0)
    want = np.asarray(maxsim_xla(jnp.asarray(Q), jnp.asarray(D), jnp.asarray(qm), jnp.asarray(dm)))
    got = ms.maxsim(*map(torch.from_numpy, (Q, D, qm, dm)))
    assert got.shape == (nq, nd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("nq,m,nd,n,h", CASES)
def test_maxsim_matches_pallas_interpret(nq, m, nd, n, h):
    Q, D, qm, dm = _inputs(nq + nd, nq, m, nd, n, h, negative_docs=3 if nq == 2 else 0)
    want = np.asarray(maxsim_pallas(jnp.asarray(Q), jnp.asarray(D), jnp.asarray(qm), jnp.asarray(dm),
                                    interpret=True))
    got = ms.maxsim(*map(torch.from_numpy, (Q, D, qm, dm)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def tf32x3(spec, a, b, terms=3):
    """``einsum(spec, a, b)`` as three TF32 products: ``a`` and ``b`` split
    into TF32 (hi, lo) as the kernels split them (``ms.tf32_split``), hi.hi
    + hi.lo + lo.hi, each product exact in fp32, sums in fp32; ``terms=1``
    keeps hi.hi alone."""
    (ah, al), (bh, bl) = ms.tf32_split(a), ms.tf32_split(b)
    return sum(torch.einsum(spec, x, y) for x, y in ((ah, bh), (ah, bl), (al, bh))[:terms])


def maxsim_tf32x3(Q, D, q_mask, d_mask):
    """Route "tf32"'s arithmetic in plain torch: the masked inputs' products
    as three TF32 products (``tf32x3``), max over doc rows, sum over query
    rows."""
    Q, D = ms._apply_masks(Q, D, q_mask, d_mask)
    return tf32x3("qmh,dnh->qdmn", Q, D).amax(dim=-1).sum(dim=-1)


@pytest.mark.parametrize("nq,m,nd,n,h", CASES)
def test_tf32x3_emulation_matches_pallas_interpret(nq, m, nd, n, h):
    Q, D, qm, dm = _inputs(2 * nq + nd, nq, m, nd, n, h, negative_docs=3 if nq == 2 else 0)
    want = np.asarray(maxsim_pallas(jnp.asarray(Q), jnp.asarray(D), jnp.asarray(qm), jnp.asarray(dm),
                                    interpret=True))
    got = maxsim_tf32x3(*map(torch.from_numpy, (Q, D, qm, dm)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("scale", [1.0, 3e-5, 7e4])
def test_tf32_split_rounds_to_nearest(scale):
    """``tf32_split``: hi keeps 10 mantissa bits, rounded to nearest with
    ties away from zero (``cvt.rna``: 1 + 2^-11 goes up, where ties to even
    would go down); lo is the rounded remainder; a single TF32 term is off
    by up to 2^-11 of |x|, hi + lo by up to 2^-21."""
    rng = np.random.default_rng(int(np.log2(scale)) + 40)
    x = torch.from_numpy((rng.normal(size=4096) * scale).astype(np.float32))
    hi, lo = ms.tf32_split(x)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((hi.double() + lo.double() - x.double()).abs() <= x.abs().double() * 2.0 ** -21).all()
    ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11)])
    assert torch.equal(ms.tf32_split(ties)[0], torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -9)]))


def test_all_negative_doc_scores_zero():
    """Masked rows are zeroed, not -inf: a doc whose valid rows all score
    negative gets 0 from its masked rows (``maxsim.py:9-11``)."""
    Q = torch.ones(1, 2, 4)
    D = torch.full((1, 3, 4), -1.0)
    got = ms.maxsim(Q, D, torch.ones(1, 2), torch.tensor([[1, 1, 0]]))
    assert got.tolist() == [[0.0]]
    assert ms.maxsim(Q, D).tolist() == [[-8.0]]


def test_gradient_matches_jax():
    """The train step differentiates the plain version; its gradient
    (``amax`` splits ties evenly) equals JAX's through ``maxsim_xla``."""
    import jax

    Q, D, qm, dm = _inputs(7, 3, 4, 5, 6, 8)
    dm[0, :] = 0  # a fully masked doc: every similarity ties at 0
    w = np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32)
    f = lambda q, d: (maxsim_xla(q, d, jnp.asarray(qm), jnp.asarray(dm)) * w).sum()
    gq, gd = jax.grad(f, argnums=(0, 1))(jnp.asarray(Q), jnp.asarray(D))
    tq, td = torch.from_numpy(Q).requires_grad_(True), torch.from_numpy(D).requires_grad_(True)
    (ms.maxsim_ref(tq, td, torch.from_numpy(qm), torch.from_numpy(dm)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq), rtol=0, atol=ATOL)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(gd), rtol=0, atol=ATOL)


def test_cpu_path_launches_no_kernel():
    before = ms.maxsim.launches.value
    ms.maxsim(torch.zeros(1, 2, 4), torch.zeros(3, 2, 4))
    assert ms.maxsim.launches.value == before
