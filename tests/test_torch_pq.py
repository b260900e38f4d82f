"""The port's product quantization (``ops/pq.py``) and pq probe
(``ops/ivf.py::ivf_probe_adc``) against the JAX package on the CPU.

Inputs come from numpy seeds.  Limits: codebooks within 1e-4 after Lloyd
iterations from JAX's own initial points (fp32 products; the per-codeword
sums run in another order); codes exact given the same codebooks (inputs
with few significant bits make every product and sum exact, so no order of
summation moves a distance across a tie); the LUT within 1e-6 (fp32 dots
of ``dsub`` terms); probe scores within 1e-5 and rows equal wherever the
scores are not within that limit of a neighbour.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu_torch.ops import ivf as pivf
from colbert_tpu_torch.ops import pq as ppq
from colbert_tpu_torch.ops.sq_probe_batched import ranked_mismatch

# The tests run in several workers at once beside JAX's own thread pools:
# two intra-op threads per worker keep the CPU from being oversubscribed.
torch.set_num_threads(2)

# the modules, not the functions of the same name that colbert_tpu.ops exports
jpq = importlib.import_module("colbert_tpu.ops.pq")
jivf = importlib.import_module("colbert_tpu.ops.ivf")

TOL = 1e-5


def clustered(seed, n, d, k=12, spread=0.2):
    rng = np.random.default_rng(seed)
    cent = rng.normal(size=(k, d)).astype(np.float32)
    return (cent[rng.integers(0, k, size=n)] + spread * rng.normal(size=(n, d))).astype(np.float32)


def few_bits(rng, shape, scale=64):
    """Values k/scale, |k| < 4*scale: sums of products stay exact in fp32."""
    return (np.round(rng.normal(size=shape) * scale) / scale).astype(np.float32)


@pytest.mark.parametrize("n,d,m,ksub,chunk", [(1500, 32, 8, 16, 512), (300, 24, 4, 256, 128)])
def test_pq_lloyd_from_jax_initial_points(n, d, m, ksub, chunk):
    x = clustered(n + m, n, d)
    key = jax.random.PRNGKey(m)
    want = np.asarray(jpq.pq_train(jnp.asarray(x), m, ksub, iters=5, key=key, chunk=chunk))
    idx = np.asarray(jax.random.choice(key, n, shape=(ksub,), replace=n < ksub))  # pq.py:56
    cb0 = torch.from_numpy(x[idx].reshape(ksub, m, d // m).transpose(1, 0, 2).copy())
    got = ppq.pq_lloyd(torch.from_numpy(x), cb0, iters=5, chunk=chunk)
    assert got.shape == (m, ksub, d // m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_pq_train_gives_a_quantizer():
    x = torch.from_numpy(clustered(3, 800, 16, spread=0.05))
    cb = ppq.pq_train(x, 4, 16, iters=8, generator=torch.Generator().manual_seed(1), chunk=256)
    assert cb.shape == (4, 16, 4) and torch.isfinite(cb).all()
    err = ((ppq.pq_decode(ppq.pq_encode(x, cb), cb) - x) ** 2).sum(dim=1).mean()
    assert float(err) < 0.2 * float((x ** 2).sum(dim=1).mean())


@pytest.mark.parametrize("m,ksub", [(8, 16), (4, 256)])
def test_encode_decode_lut_and_scores_match_jax(m, ksub):
    rng = np.random.default_rng(m + ksub)
    d = 32
    x = few_bits(rng, (700, d))
    cb = few_bits(rng, (m, ksub, d // m))
    cb[:, 1] = cb[:, 0]  # tied codewords: the first wins
    want = np.asarray(jpq.pq_encode(jnp.asarray(x), jnp.asarray(cb), chunk=256))
    got = ppq.pq_encode(torch.from_numpy(x), torch.from_numpy(cb), chunk=256)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert not (want == 1).any()
    np.testing.assert_array_equal(ppq.pq_decode(got, torch.from_numpy(cb)).numpy(),
                                  np.asarray(jpq.pq_decode(jnp.asarray(want), jnp.asarray(cb))))
    q = rng.normal(size=(5, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)  # unit rows, as the encoder writes
    jlut = jpq.adc_lut(jnp.asarray(q), jnp.asarray(cb))
    lut = ppq.adc_lut(torch.from_numpy(q), torch.from_numpy(cb))
    np.testing.assert_allclose(lut.numpy(), np.asarray(jlut), rtol=0, atol=1e-6)
    codes, tlut = jnp.asarray(want[:90]), torch.from_numpy(np.array(jlut))
    np.testing.assert_allclose(ppq.adc_score(tlut, got[:90]).numpy(),
                               np.asarray(jpq.adc_score(jlut, codes)), rtol=0, atol=TOL)
    np.testing.assert_allclose(ppq.adc_score_onehot(tlut, got[:90]).numpy(),
                               np.asarray(jpq.adc_score_onehot(jlut, codes)), rtol=0, atol=TOL)


def _adc_inputs(seed, T, K, d, m, ksub, max_len):
    """A CSR pq index: codes (N, m) uint8 sorted by list, offsets with an
    empty list and a long one, duplicate code rows within and across lists;
    few-bit queries and centroids, so the coarse scores are exact."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, size=K)
    lens[1], lens[2] = 0, max_len
    offsets = np.zeros(K + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    codes = rng.integers(0, ksub, size=(int(offsets[-1]), m)).astype(np.uint8)
    b = offsets[2]
    codes[b + 3] = codes[b + 40]             # a tie within a list: the lower row wins
    codes[offsets[3]] = codes[b + 7]          # a tie across lists: the earlier-probed list wins
    cb = rng.normal(size=(m, ksub, d // m)).astype(np.float32)
    q = few_bits(rng, (T, d), 16)
    coarse = few_bits(rng, (K, d), 16)
    return q, coarse, cb, codes, offsets


@pytest.mark.parametrize("T,K,nprobe,depth", [(40, 12, 4, 30), (9, 7, 7, 200)])
def test_ivf_probe_adc_matches_jax_gather(T, K, nprobe, depth):
    d, m, ksub = 32, 8, 16
    q, coarse, cb, codes, offsets = _adc_inputs(T + K, T, K, d, m, ksub, max_len=60)
    cap = int(np.diff(offsets).max())
    c = q @ coarse.T
    assert all(len(np.unique(row)) == K for row in c)  # no coarse tie: both take one list order
    js, jr = jivf.ivf_probe_adc(jnp.asarray(q), jnp.asarray(coarse), jnp.asarray(cb), jnp.asarray(codes),
                                jnp.asarray(offsets), nprobe=nprobe, cap=cap, depth=depth,
                                token_chunk=min(32, T), adc_method="gather")
    ps, pr = pivf.ivf_probe_adc(torch.from_numpy(q), torch.from_numpy(coarse), torch.from_numpy(cb),
                                torch.from_numpy(codes), torch.from_numpy(offsets),
                                nprobe=nprobe, cap=cap, depth=depth)
    assert ps.shape == (T, depth) and pr.dtype == torch.int32
    err, bad = ranked_mismatch(torch.from_numpy(np.asarray(js)), torch.from_numpy(np.asarray(jr)), ps, pr, TOL)
    assert err <= TOL and bad == 0, (err, bad)
    assert (pr.numpy() >= 0).sum() > T  # real candidates, not all padding
