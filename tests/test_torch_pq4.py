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


# ---- route "onehot": its work list and its arithmetic, on the CPU ----

def _probes(rng, T, K, nprobe, every=None):
    """(T, nprobe) distinct lists a token; list ``every`` probed by every token."""
    rows = []
    for _ in range(T):
        p = [int(l) for l in rng.permutation(K)]
        if every is not None:
            p.remove(every)
            p.insert(int(rng.integers(0, nprobe)), every)
        rows.append(p[:nprobe])
    return np.array(rows, np.int32)


@pytest.mark.parametrize("kind", ["serving", "every_token_one_list", "small"])
def test_pq4_work_list_matches_numpy(kind):
    """Every (token, probe) pair in exactly one item, an item's members in
    ascending token order and at most 64, a list's items in its pair order,
    an empty list probed by a token still an item, a list no token probes
    none, and the items ordered most work first (64-row tiles x 16-token
    tiles, capped at the last bucket)."""
    T, K, nprobe = {"serving": (2304, 4096, 128), "every_token_one_list": (300, 40, 6), "small": (9, 30, 2)}[kind]
    rng = np.random.default_rng(T + K)
    lens = rng.integers(0, 400, size=K)
    lens[1] = 0
    lists = _probes(rng, T, K, nprobe, every=1 if kind != "small" else None)
    offsets = np.zeros(K + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    wl = ppq4.pq4_work_list(torch.from_numpy(lists), torch.from_numpy(offsets))
    n = int(wl.count)
    items, pairs = wl.items.numpy(), wl.pairs.numpy()
    assert items.shape == (ppq4.max_items(T * nprobe, K),) and (items[n:] == -1).all()
    # the numpy loop: each list's pairs in (token, probe) order, cut into 64s
    want = {}
    for p, l in enumerate(lists.reshape(-1)):
        want.setdefault(int(l), []).append(p)
    got = {}
    for ps in items[:n]:
        l = int(lists.reshape(-1)[pairs[ps]])
        cnt, start = int(wl.cnt[l]), int(wl.lstart[l])
        assert start <= ps < start + cnt and (ps - start) % ppq4.ONEHOT_GROUP == 0
        got.setdefault(l, []).append(pairs[ps : min(ps + ppq4.ONEHOT_GROUP, start + cnt)].tolist())
    assert sorted(got) == sorted(want)
    for l, chunks in got.items():
        chunks.sort()
        assert sum(chunks, []) == want[l]  # every pair once, ascending token within the list
        assert all(len(c) <= ppq4.ONEHOT_GROUP for c in chunks)
    if kind != "small":
        assert len(got[1]) == -(-T // ppq4.ONEHOT_GROUP) and lens[1] == 0  # the empty list, every token
    l_of = lists.reshape(-1)[pairs[items[:n]]]
    members = np.minimum(wl.cnt.numpy()[l_of] + wl.lstart.numpy()[l_of] - items[:n], ppq4.ONEHOT_GROUP)
    key = np.minimum(-(-lens[l_of] // 64) * -(-members // 16), ppq4.WORK_BUCKETS - 1)
    assert (np.diff(key) <= 0).all()


@pytest.mark.parametrize("m,r,ok", [(8, 1, True), (128, 8, True), (256, 16, True),
                                    (12, 8, False), (512, 8, False), (128, 0, False), (128, 17, False)])
def test_pq4_scan_plan_routes_every_k8_shape(m, r, ok):
    """Route "onehot" takes every shape K8 takes (m/2 in 4..128 bytes, a
    power of two; r 1..16); any other shape raises before a launch."""
    if ok:
        assert ppq4.pq4_scan_plan(m, r) == "onehot"
    else:
        with pytest.raises(ValueError):
            ppq4.pq4_scan_plan(m, r)


def onehot_items_scan(lists, offsets, lut, codes, r):
    """Route "onehot"'s arithmetic in numpy, item by item of the plain work
    list: each list's rows scored for the item's members as one product of
    the rows' one-hot nibbles (m x 16 columns) and the members' bf16 LUT,
    then each member's top r under the key (score desc, 128-row block
    counted from the list start desc, row asc)."""
    T, nprobe = lists.shape
    m = lut.shape[1]
    wl = ppq4.pq4_work_list(torch.from_numpy(lists), torch.from_numpy(offsets))
    lutb = torch.from_numpy(lut).to(torch.bfloat16).float().numpy().reshape(T, m * 16)
    nib = ppq4.pq4_unpack(torch.from_numpy(codes)).numpy().astype(np.int64)
    out_s = np.full((T * nprobe, r), -np.inf, np.float32)
    out_r = np.full((T * nprobe, r), -1, np.int32)
    cnt, lstart, pairs = wl.cnt.numpy(), wl.lstart.numpy(), wl.pairs.numpy()
    for ps in wl.items.numpy()[: int(wl.count)]:
        l = lists.reshape(-1)[pairs[ps]]
        mem = pairs[ps : min(ps + ppq4.ONEHOT_GROUP, lstart[l] + cnt[l])]
        lo, hi = offsets[l], offsets[l + 1]
        onehot = np.zeros((hi - lo, m * 16), np.float32)
        onehot[np.arange(hi - lo)[:, None], np.arange(m) * 16 + nib[lo:hi]] = 1.0
        scores = onehot @ lutb[mem // nprobe].T                        # (rows, members)
        rel = np.arange(hi - lo)
        for c, p in enumerate(mem):
            top = np.lexsort((rel, -(rel // 128), -scores[:, c]))[:r]
            out_s[p, : len(top)] = scores[top, c]
            out_r[p, : len(top)] = lo + rel[top]
    return out_s.reshape(T, nprobe, r), out_r.reshape(T, nprobe, r)


@pytest.mark.parametrize("m,r", [(16, 2), (128, 8)])
def test_k8_onehot_items_match_jax_kernel(m, r):
    """The one-hot product over the work list's items, with the total-order
    top r, equals the TPU kernel in interpret mode: scores within 1e-5, rows
    equal outside near ties, the planted exact ties within and across
    128-row blocks resolved alike; the tied list is probed by every token
    (more than one item) and the empty list by some."""
    rng = np.random.default_rng(7 * m + r)
    T, K, nprobe = 140, 9, 4
    assert T > ppq4.ONEHOT_GROUP  # the list every token probes makes two items
    codes, offsets = tied_csr(rng, K, m // 2, 140)
    lists = _probes(rng, T, K, nprobe, every=2)
    assert (lists == 1).any()  # the empty list is probed
    lut = rng.normal(scale=0.05, size=(T, m, 16)).astype(np.float32)
    ws, wr = jax_block_scan(lists, offsets, lut, codes, r)
    gs, gr = onehot_items_scan(lists, offsets, lut, codes, r)
    flat = lambda a: torch.as_tensor(np.ascontiguousarray(a)).reshape(T * nprobe, r)
    err, bad = ranked_mismatch(flat(ws), flat(wr), flat(gs), flat(gr), TOL)
    assert err <= TOL and bad == 0, (err, bad)
    tied = gs[lists == 2]
    assert (tied[:, 1:] == tied[:, :-1]).any()  # exact ties were compared
