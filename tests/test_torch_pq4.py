"""The port's PQ4 codec (``ops/pq4.py``) against the JAX package on the CPU:
nibble packing, encoding, the plain version of K8 (the per-(token, list)
top-r list scan) against the TPU kernel ``pq4_block_scan`` in interpret
mode, and the whole ``ivf_probe_pq4``.

Inputs come from numpy seeds.  Limits: packing and codes exact (few-bit
inputs keep every distance exact); scores within 1e-5 (sums of bf16 LUT
entries in fp32, in another order); rows equal wherever the scores are not
within that limit of a neighbour.  Exact ties, from duplicate code rows
planted within and across the TPU kernel's 128-row blocks, must resolve
alike: both sides apply the TPU kernel's merge.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu_torch.ops import pq4 as ppq4
from colbert_tpu_torch.ops.sq_probe_batched import ranked_mismatch

# The tests run in several workers at once beside JAX's own thread pools:
# two intra-op threads per worker keep the CPU from being oversubscribed.
torch.set_num_threads(2)

jpq4 = importlib.import_module("colbert_tpu.ops.pq4")

TOL = 1e-5


def few_bits(rng, shape, scale):
    return (np.round(rng.normal(size=shape) * scale) / scale).astype(np.float32)


def test_pack_unpack_round_trip():
    rng = np.random.default_rng(0)
    nibs = rng.integers(0, 16, size=(40, 32)).astype(np.uint8)
    packed = (nibs[:, 0::2] | (nibs[:, 1::2] << 4)).view(np.int8)
    got = ppq4.pq4_unpack(torch.from_numpy(packed))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), nibs)
    np.testing.assert_array_equal(got.numpy(), jpq4.pq4_unpack(packed))


@pytest.mark.parametrize("m", [16, 128])
def test_encode_packed_byte_equal_to_jax(m):
    rng = np.random.default_rng(m)
    d = 256
    x = few_bits(rng, (300, d), 64)
    cb = few_bits(rng, (m, 16, d // m), 64)
    want = jpq4.pq4_encode_packed(jnp.asarray(x), jnp.asarray(cb), chunk=128)
    got = ppq4.pq4_encode_packed(torch.from_numpy(x), torch.from_numpy(cb), chunk=128)
    assert got.dtype == torch.int8 and got.shape == (300, m // 2)
    np.testing.assert_array_equal(got.numpy(), want)
    train = ppq4.pq4_train(torch.from_numpy(x), m, iters=2, generator=torch.Generator().manual_seed(0), chunk=128)
    assert train.shape == (m, 16, d // m)


def tied_csr(rng, K, bpr, max_len):
    """Packed codes (N, bpr) int8 sorted by list and offsets (K+1,): list 1
    empty, list 0 a single row, list 2 longer than two 128-row blocks and
    drawn from five distinct rows (exact ties within and across blocks),
    one row of list 3 a copy of a row of list 2."""
    lens = rng.integers(2, max_len + 1, size=K)
    lens[0], lens[1], lens[2] = 1, 0, 300
    offsets = np.zeros(K + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    codes = rng.integers(-128, 128, size=(int(offsets[-1]), bpr)).astype(np.int8)
    pool = codes[offsets[2] : offsets[2] + 5].copy()
    codes[offsets[2] : offsets[3]] = pool[rng.integers(0, 5, size=300)]
    codes[offsets[3] + 1] = pool[0]
    return codes, offsets


def jax_block_scan(lists, offsets, lut, codes, r):
    """The TPU kernel in interpret mode, gathered at each token's probed
    lists: (T, nprobe, r) scores and CSR rows; -inf / -1 for an empty list."""
    T, nprobe = lists.shape
    K = offsets.shape[0] - 1
    t_pad = -(-T // 128) * 128
    blocks = jpq4.build_pq4_blocks(codes, offsets)
    member = np.zeros((K, 1, t_pad), np.int8)
    member[lists.T, 0, np.arange(T)[None, :]] = 1
    plane = lambda p: jnp.pad(jnp.asarray(lut[:, p::2, :].reshape(T, -1)), ((0, t_pad - T), (0, 0))).T
    js, jr = jpq4.pq4_block_scan(jnp.asarray(jpq4.pq4_meta(blocks)), jnp.asarray(member),
                                 jnp.asarray(blocks.codes2), plane(0), plane(1), r=r, num_lists=K,
                                 interpret=True)
    js, jr = np.asarray(js), np.asarray(jr)
    jr = np.where(jr >= 0, blocks.row_of_padded[np.maximum(jr, 0)], -1)
    s = js[lists, :, np.arange(T)[:, None]]                     # (T, nprobe, r)
    rows = jr[lists, :, np.arange(T)[:, None]]
    empty = (np.diff(offsets) == 0)[lists][..., None]
    return np.where(empty, -np.inf, s), np.where(empty, -1, rows)


@pytest.mark.parametrize("m,r", [(16, 2), (16, 8), (128, 8)])
def test_k8_plain_matches_jax_kernel(m, r):
    rng = np.random.default_rng(m + r)
    T, K, nprobe = 24, 9, 5
    codes, offsets = tied_csr(rng, K, m // 2, 140)
    lists = []
    for t in range(T):  # tokens 0-5 probe the tied list first, tokens 6-11 the empty one second
        p = [int(l) for l in rng.permutation(K)]
        if t < 12:
            p.remove(2 if t < 6 else 1)
            p.insert(0 if t < 6 else 1, 2 if t < 6 else 1)
        lists.append(p[:nprobe])
    lists = np.array(lists, np.int32)
    lut = rng.normal(scale=0.05, size=(T, m, 16)).astype(np.float32)
    ws, wr = jax_block_scan(lists, offsets, lut, codes, r)
    gs, gr = ppq4.pq4_list_scan(torch.from_numpy(lists), torch.from_numpy(offsets), torch.from_numpy(lut),
                                torch.from_numpy(codes), r=r)
    assert gs.shape == (T, nprobe, r) and gr.dtype == torch.int32
    flat = lambda a: torch.as_tensor(np.ascontiguousarray(a)).reshape(T * nprobe, r)
    err, bad = ranked_mismatch(flat(ws), flat(wr), flat(gs.numpy()), flat(gr.numpy()), TOL)
    assert err <= TOL and bad == 0, (err, bad)
    tied = ws[:6, 0]
    assert (tied[:, 1:] == tied[:, :-1]).any()  # exact ties were compared
    assert not np.isfinite(gs.numpy()[6:12, 1]).any()  # the empty list yields -inf / -1
    assert (gr.numpy()[6:12, 1] == -1).all()


def _probe_inputs(seed, T, K, d, m):
    """A pq4 index with few-bit queries, centroids and codebooks: the coarse
    scores and the fp32 LUT are exact in both packages, so the bf16 LUT is
    too."""
    rng = np.random.default_rng(seed)
    codes, offsets = tied_csr(rng, K, m // 2, 150)
    q = few_bits(rng, (T, d), 16)
    coarse = few_bits(rng, (K, d), 16)
    coarse[2] = q[:8].mean(axis=0).round(3)    # many tokens probe the tied list first
    coarse = np.round(coarse * 16) / 16
    cb = few_bits(rng, (m, 16, d // m), 64)
    return q, coarse, cb, codes, offsets


@pytest.mark.parametrize("depth", [12, 64])
def test_ivf_probe_pq4_matches_jax(depth):
    T, K, d, m, nprobe, r = 30, 10, 64, 16, 4, 4
    q, coarse, cb, codes, offsets = _probe_inputs(depth, T, K, d, m)
    assert all(len(np.unique(row)) == K for row in q @ coarse.T)  # no coarse tie
    blocks = jpq4.build_pq4_blocks(codes, offsets)
    js, jr = jpq4.ivf_probe_pq4(
        jnp.asarray(q), jnp.asarray(coarse), jnp.asarray(cb), jnp.asarray(jpq4.pq4_meta(blocks)),
        jnp.asarray(blocks.codes2), jnp.asarray(blocks.row_of_padded),
        jnp.asarray((np.diff(offsets) > 0).astype(np.int32)),
        nprobe=nprobe, depth=depth, r=r, num_lists=K, interpret=True)
    ps, pr = ppq4.ivf_probe_pq4(torch.from_numpy(q), torch.from_numpy(coarse), torch.from_numpy(cb),
                                torch.from_numpy(codes), torch.from_numpy(offsets),
                                nprobe=nprobe, depth=depth, r=r)
    assert ps.shape == (T, depth) and pr.dtype == torch.int32
    err, bad = ranked_mismatch(torch.from_numpy(np.asarray(js)), torch.from_numpy(np.asarray(jr)), ps, pr, TOL)
    assert err <= TOL and bad == 0, (err, bad)
    tied = (pr.numpy() >= offsets[2]) & (pr.numpy() < offsets[3])
    assert tied.any(axis=1).sum() >= 4  # the tied list reached several tokens' candidates
