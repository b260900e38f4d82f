"""The port's rerank (K4 over bf16, K5 over int8) against the TPU kernels
in interpret mode, and its int8 quantization against the JAX package's.

The JAX kernels take candidate counts that are multiples of 128, so they
get the port's candidates padded with -1; the port takes any count.  The
JAX int8 kernel reads ``pack_int8_table`` of the same int8 table the port
reads unpacked.  Limit: scores within 1e-4 (products exact in fp32 for
bf16 x bf16; only the summation order differs), -inf at -1 slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.ops import rerank_pallas as jrp
from colbert_tpu_torch.ops import rerank as prr

# The tests run in several workers at once beside JAX's own thread pools:
# two intra-op threads per worker keep the CPU from being oversubscribed.
torch.set_num_threads(2)

TOL = 1e-4


def _case(seed, num_docs, dv, dim, B, qv, C):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(num_docs * dv, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    Qm = rng.normal(size=(B, qv, dim)).astype(np.float32)
    Qm /= np.linalg.norm(Qm, axis=-1, keepdims=True)
    Qm[0, qv // 2 :] = 0.0  # masked views
    cand = rng.integers(0, num_docs, size=(B, C)).astype(np.int32)
    cand[rng.random((B, C)) < 0.2] = -1
    cand[1] = -1  # a query with no candidate
    return emb.astype(np.float16), Qm, cand


def _pad128(cand):
    C = cand.shape[1]
    return np.pad(cand, ((0, 0), (0, -(-C // 128) * 128 - C)), constant_values=-1)


@pytest.mark.parametrize("num_docs,dv,dim,B,qv,C", [
    (60, 16, 128, 3, 8, 200),
    (40, 8, 64, 2, 4, 128),
    (30, 5, 32, 4, 3, 77),
])
def test_k4_plain_matches_jax_kernel(num_docs, dv, dim, B, qv, C):
    emb, Qm, cand = _case(num_docs + C, num_docs, dv, dim, B, qv, C)
    want = np.asarray(jrp.maxsim_rerank_uniform(
        jnp.asarray(_pad128(cand)), jnp.asarray(Qm), jnp.asarray(emb.astype(np.float32), jnp.bfloat16),
        dv=dv, interpret=True))[:, :C]
    table = torch.from_numpy(emb).to(torch.bfloat16)
    got = prr.maxsim_rerank_uniform(torch.from_numpy(cand), torch.from_numpy(Qm), table, dv=dv)
    assert got.shape == (B, C) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_array_equal(np.isfinite(got), cand >= 0)
    np.testing.assert_allclose(got[cand >= 0], want[cand >= 0], rtol=0, atol=TOL)
    assert np.isneginf(want[cand < 0]).all()


@pytest.mark.parametrize("num_docs,dv,dim,B,qv,C", [
    (50, 16, 256, 3, 8, 150),   # (dim/128)*dv = 32: the JAX int8 table's packing
    (40, 32, 128, 2, 4, 128),
])
def test_k5_plain_matches_jax_kernel(num_docs, dv, dim, B, qv, C):
    emb, Qm, cand = _case(num_docs * 3 + C, num_docs, dv, dim, B, qv, C)
    q8, scale = prr.quantize_emb_table(emb)
    inv = (1.0 / scale).astype(np.float32)
    Qs = Qm * inv
    want = np.asarray(jrp.maxsim_rerank_uniform_packed(
        jnp.asarray(_pad128(cand)), jnp.asarray(Qs), jnp.asarray(jrp.pack_int8_table(q8, dv)),
        dv=dv, nk=dim // 128, interpret=True))[:, :C]
    got = prr.maxsim_rerank_uniform_int8(torch.from_numpy(cand), torch.from_numpy(Qs),
                                         torch.from_numpy(q8), dv=dv).numpy()
    np.testing.assert_array_equal(np.isfinite(got), cand >= 0)
    np.testing.assert_allclose(got[cand >= 0], want[cand >= 0], rtol=0, atol=TOL)


@pytest.mark.parametrize("chunk", [7, 1 << 18])
def test_quantize_matches_jax_numpy_path(monkeypatch, chunk):
    """Bit-equal to the JAX package's numpy path (its native fast path is
    switched off here: the tracked library is built for another CPU)."""
    import colbert_tpu.native.lib as native

    monkeypatch.setattr(native, "_load", lambda: None)
    rng = np.random.default_rng(chunk)
    emb = (rng.normal(size=(50, 96)) * rng.random(96)).astype(np.float16)
    emb[:, 5] = 0  # an all-zero dim: scale 127 / 1e-6
    want_q, want_s = jrp.quantize_emb_table(emb, chunk=chunk)
    got_q, got_s = prr.quantize_emb_table(emb, chunk=chunk)
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(got_s, want_s)
