"""The port's token-major sq probe against the JAX package on the CPU: the
plain version of K10 (``ops/sq_probe.py``, the list-window scan) against
the TPU kernel ``sq_list_scan`` in interpret mode, the top-k tie rule, and
the whole ``ivf_probe_sq`` against the JAX package's Pallas path.

Inputs come from numpy seeds.  Limits: scores within 1e-5 (fp32 queries x
int8 codes summed in another order); the -inf pattern exact; rows equal
wherever the scores are not within that limit of a neighbour.  Exact ties
(duplicate code rows, planted within and across lists) must resolve alike:
the lowest (probe rank, row) first, as ``jax.lax.top_k``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.ops.sq_probe_pallas import pad_codes_for_scan, sq_list_scan as j_sq_list_scan
from colbert_tpu_torch.ops import ivf as pivf
from colbert_tpu_torch.ops import sq_probe as psq
from colbert_tpu_torch.ops.sq_probe_batched import ranked_mismatch

# The tests run in several workers at once beside JAX's own thread pools:
# two intra-op threads per worker keep the CPU from being oversubscribed.
torch.set_num_threads(2)

jivf = importlib.import_module("colbert_tpu.ops.ivf")
jsq = importlib.import_module("colbert_tpu.ops.sq")

TOL = 1e-5


@pytest.mark.parametrize("D", [16, 64])
def test_k10_plain_matches_jax_kernel(D):
    rng = np.random.default_rng(D)
    T, nprobe, N = 6, 5, 700
    codes = rng.integers(-127, 128, size=(N, D)).astype(np.int8)
    qs = (rng.normal(size=(T, D)) / (127.0 * np.sqrt(D))).astype(np.float32)
    starts = rng.integers(0, N - 200, size=(T, nprobe)).astype(np.int32)
    lens = rng.integers(2, 120, size=(T, nprobe)).astype(np.int32)
    starts[0, 0] = 33                     # a window that does not start on a 32-row boundary
    lens[:, 1], lens[:, 2], lens[:, 3] = 0, 1, 170  # empty, one row, more than 128 rows
    cap = int(lens.max())
    got = psq.sq_list_scan(torch.from_numpy(starts), torch.from_numpy(lens), torch.from_numpy(qs),
                           torch.from_numpy(codes), cap=cap)
    assert got.shape == (T, nprobe * cap) and got.dtype == torch.float32
    # the TPU kernel's windows: starts aligned down to 32 rows, cap padded to 128
    cap_j = -(-(cap + 31) // 128) * 128
    aligned = starts // 32 * 32
    lo = starts - aligned
    want = np.asarray(j_sq_list_scan(jnp.asarray(aligned), jnp.asarray(lo), jnp.asarray(lo + lens),
                                     jnp.asarray(qs), pad_codes_for_scan(jnp.asarray(codes), cap_j),
                                     cap=cap_j, interpret=True)).reshape(T, nprobe, cap_j)
    i = np.arange(cap)
    want = np.take_along_axis(want, np.minimum(lo[..., None] + i, cap_j - 1), axis=2)
    want = np.where(i < lens[..., None], want, -np.inf).reshape(T, nprobe * cap)
    got = got.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=TOL)
    assert fin.sum() == lens.sum()


def test_topk_first_keeps_the_lowest_column_among_ties():
    rng = np.random.default_rng(1)
    s = rng.integers(-3, 4, size=(7, 60)).astype(np.float32) / 4
    s[:, ::7] = -np.inf
    s[2] = 0.0
    s[3, ::2] = -0.0  # below +0.0 in top_k's order
    s[4] = -np.inf
    want_s, want_i = jax.lax.top_k(jnp.asarray(s), 25)
    got_s, got_i = pivf.topk_first(torch.from_numpy(s), 25)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def _probe_inputs(seed, T, K, D, dim=32, n_per_list=60):
    """A clustered sq index with few-bit queries and centroids (the coarse
    scores are exact in both packages), a long list, an empty one, and
    duplicate code rows within a list and across lists."""
    rng = np.random.default_rng(seed)
    cent = np.round(rng.normal(size=(K, dim)) * 8) / 8
    sizes = rng.integers(1, 2 * n_per_list, size=K)
    sizes[0], sizes[1] = 5 * n_per_list, 0
    x = np.concatenate([c + 0.3 * rng.normal(size=(n, dim)) for c, n in zip(cent, sizes)]).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    assign = np.repeat(np.arange(K), sizes).astype(np.int32)
    proj, scales = jsq.sq_train(jnp.asarray(x), D)
    codes = np.asarray(jsq.sq_encode(jnp.asarray(x), proj, scales))
    perm, offsets = jivf.sort_by_list(assign, K)
    codes = codes[perm]
    q = np.round((cent[rng.integers(0, K, size=T)] + 0.5 * rng.normal(size=(T, dim))) * 8) / 8
    q[: T // 2] = np.round((cent[0] + 0.3 * rng.normal(size=(T // 2, dim))) * 8) / 8
    q, cent, proj, scales = (np.asarray(a, np.float32) for a in (q, cent, proj, scales))
    # token 0's best row copied into another 128-row block of its list and
    # into its next probed list: exact ties at the top of its candidates
    first, second = np.argsort(-(q[0] @ cent.T), kind="stable")[:2]
    lo, hi = offsets[first], offsets[first + 1]
    best = lo + int(np.argmax(codes[lo:hi].astype(np.float32) @ (q[0] @ proj / scales)))
    dups = [lo + (best - lo + 130) % (hi - lo), offsets[second]]
    codes[dups] = codes[best]
    return q, cent, proj, scales, codes, offsets, [best, *dups]


@pytest.mark.parametrize("D,depth", [(16, 20), (64, 300)])
def test_ivf_probe_sq_matches_jax_pallas_path(D, depth):
    T, K, nprobe = 40, 12, 4
    q, cent, proj, scales, codes, offsets, tied = _probe_inputs(D, T, K, D)
    assert all(len(np.unique(row)) == K for row in q @ cent.T)  # no coarse tie
    cap = int(np.diff(offsets).max())
    js, jr = jivf.ivf_probe_sq(jnp.asarray(q), jnp.asarray(cent), jnp.asarray(proj), jnp.asarray(scales),
                               jnp.asarray(codes), jnp.asarray(offsets), nprobe=nprobe, cap=cap, depth=depth,
                               token_chunk=min(32, T), use_pallas=True)
    ps, pr = pivf.ivf_probe_sq(torch.from_numpy(q), torch.from_numpy(cent), torch.from_numpy(proj),
                               torch.from_numpy(scales), torch.from_numpy(codes), torch.from_numpy(offsets),
                               nprobe=nprobe, cap=cap, depth=depth)
    assert ps.shape == (T, depth) and pr.dtype == torch.int32
    err, bad = ranked_mismatch(torch.from_numpy(np.asarray(js)), torch.from_numpy(np.asarray(jr)), ps, pr, TOL)
    assert err <= TOL and bad == 0, (err, bad)
    assert sorted(pr.numpy()[0, :3].tolist()) == sorted(tied)  # the planted ties were compared
