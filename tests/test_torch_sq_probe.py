"""The port's sq probe against the JAX package on the CPU: the dense slot
schedule, K6's work list (route "mma") against the JAX schedule's filled
slots, K6's tie rule as a total order (a plain sort under it against the
TPU kernel), the plain versions of K6 (slot list scan) and K7 (hot-list scan,
over every token and over member tokens) against the TPU kernels in
interpret mode, K7's member-token slots (route "mma") against a numpy
layout of the JAX probe's membership, the three bf16 terms of K7's query
operand, the whole ``ivf_probe_sq_batched`` with and without hot lists (and
with hot lists over members or every token), and both dedups.

Inputs come from numpy seeds.  Limits: scores within 1e-5 (the int8 x
bf16 or x fp32 products are summed in another order); rows and pids equal
wherever the scores are not within that limit of a neighbour.  Exact ties
(duplicate code rows, planted here) must resolve alike: both sides apply
the TPU kernel's tie rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.ops import ivf as jivf
from colbert_tpu.ops import sq_probe_batched as jsp
from colbert_tpu.ops.sq_probe_pallas import pad_codes_for_scan
from colbert_tpu_torch.ops import ivf as pivf
from colbert_tpu_torch.ops import sq_probe_batched as psp

# The tests run in several workers at once beside JAX's own thread pools:
# two intra-op threads per worker keep the CPU from being oversubscribed.
torch.set_num_threads(2)

TOL = 1e-5


def assert_ranked_match(s_want, r_want, s_got, r_got, axis, tol=TOL):
    """Scores within ``tol``; ids equal except where a score lies within
    ``tol`` of a different neighbouring score along ``axis`` (a near tie
    that the summation order may flip)."""
    def rows(a):
        a = np.moveaxis(np.asarray(a), axis, -1)
        return torch.from_numpy(np.ascontiguousarray(a.reshape(-1, a.shape[-1])))

    err, bad = psp.ranked_mismatch(rows(s_want), rows(r_want), rows(s_got), rows(r_got), tol)
    assert err <= tol and bad == 0, (err, bad)


def random_csr(rng, K, D, max_len, dup=True):
    """Codes (N, D) int8 sorted by list, offsets (K+1,); some lists empty,
    some longer than one 128-row block, with duplicate rows planted inside
    a block and across blocks."""
    lens = rng.integers(0, max_len + 1, size=K)
    lens[1] = 0
    lens[2] = max_len
    offsets = np.zeros(K + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    codes = rng.integers(-127, 128, size=(int(offsets[-1]), D)).astype(np.int8)
    if dup:
        b = offsets[2]
        codes[b + 5] = codes[b + 140]   # tie across blocks: the later block wins
        codes[b + 7] = codes[b + 9]     # tie within a block: the lower row wins
    return codes, offsets


def scaled_queries(rng, T, D):
    """Projected queries at the scale ``sq_query`` gives (scores ~ 1)."""
    return (rng.normal(size=(T, D)) / (127.0 * np.sqrt(D))).astype(np.float32)


def jax_schedule(coarse, nprobe, offsets, tpl, groups, D, list_mask=None):
    vals, lists = jax.lax.top_k(jnp.asarray(coarse), nprobe)
    sched, pv = jsp.build_slot_schedule_dense(
        jnp.asarray(coarse), vals[:, -1], lists, jnp.asarray(offsets), tpl=tpl, pack=128 // D,
        groups=groups, list_mask=None if list_mask is None else jnp.asarray(list_mask),
    )
    return sched, pv, np.asarray(vals), np.asarray(lists)


@pytest.mark.parametrize("T,K,nprobe,tpl,groups,masked", [
    (40, 12, 4, 8, 2, False),
    (70, 16, 5, 4, 3, True),
])
def test_slot_schedule_matches_jax(T, K, nprobe, tpl, groups, masked):
    rng = np.random.default_rng(T)
    coarse = rng.normal(size=(T, K)).astype(np.float32)
    mask = rng.random(K) < 0.7 if masked else None
    offsets = np.arange(K + 1, dtype=np.int32) * 9
    sched, pv, vals, lists = jax_schedule(coarse, nprobe, offsets, tpl, groups, 16, mask)
    member = torch.from_numpy(coarse >= vals[:, -1:])
    if masked:
        member &= torch.from_numpy(mask)[None, :]
    got, got_pv = psp.build_slot_schedule_dense(member, torch.from_numpy(lists), tpl=tpl, groups=groups)
    np.testing.assert_array_equal(got.qidx.numpy(), np.asarray(sched.qidx))
    v = np.asarray(pv)
    np.testing.assert_array_equal(got_pv.numpy(), v)
    assert v.any() and not v.all()  # some pairs overflow their list's slots
    np.testing.assert_array_equal(got.slot_of_pair.numpy()[v], np.asarray(sched.slot_of_pair)[v])
    np.testing.assert_array_equal(got.pos_of_pair.numpy()[v], np.asarray(sched.pos_of_pair)[v])


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("r", [2, 8])
def test_k6_plain_matches_jax_kernel(D, r):
    rng = np.random.default_rng(D + r)
    T, K, nprobe, tpl, groups = 40, 12, 4, 8, 2
    codes, offsets = random_csr(rng, K, D, 300)
    qs = scaled_queries(rng, T, D)
    coarse = rng.normal(size=(T, K)).astype(np.float32)
    sched, _, vals, lists = jax_schedule(coarse, nprobe, offsets, tpl, groups, D)
    maxb = (int(np.diff(offsets).max()) + 31 + 127) // 128
    t_pad = -(-T // 128) * 128
    qsT = jnp.pad(jnp.asarray(qs), ((0, t_pad - T), (0, 0))).T
    js, jr = jsp.sq_batch_list_scan(sched.qidx, sched.meta, qsT, pad_codes_for_scan(jnp.asarray(codes), maxb * 128),
                                    tpl=tpl, r=r, interpret=True)
    qidx = torch.from_numpy(np.asarray(sched.qidx))
    ps, pr = psp.sq_batch_list_scan(qidx, torch.from_numpy(offsets), torch.from_numpy(qs),
                                    torch.from_numpy(codes), r=r)
    # compare the slots the TPU kernel ran, at filled positions
    ran = np.asarray(sched.meta)[:, 0, 1] > 0
    js, jr = np.asarray(js)[ran], np.asarray(jr)[ran]
    ps, pr = ps.numpy()[ran], pr.numpy()[ran]
    filled = np.broadcast_to((qidx.numpy()[ran] >= 0)[:, None, :], js.shape)
    js = np.where(filled, js, -np.inf)
    jr = np.where(filled, jr, -1)
    assert_ranked_match(js, jr, ps, pr, axis=1)
    assert np.isfinite(ps).sum() > 100


def total_order_topr(qidx, offsets, qs, codes, r):
    """K6 by sorting each filled slot's list rows under the key (score
    desc, 128-row block desc, row asc), blocks from the list offset rounded
    down to 32 rows: the order of visits plays no part."""
    S, tpl = qidx.shape
    K = len(offsets) - 1
    out_s = np.full((S, r, tpl), -np.inf, np.float32)
    out_r = np.full((S, r, tpl), -1, np.int32)
    qb = torch.from_numpy(qs).to(torch.bfloat16).float().numpy()
    for s in np.flatnonzero(qidx[:, 0] >= 0):
        lo, hi = offsets[s % K], offsets[s % K + 1]
        rows = np.arange(lo, hi)
        block = (rows - (lo - lo % 32)) // 128
        for p in np.flatnonzero(qidx[s] >= 0):
            score = codes[lo:hi].astype(np.float32) @ qb[qidx[s, p]]
            top = np.lexsort((rows, -block, -score))[:r]
            out_s[s, : len(top), p] = score[top]
            out_r[s, : len(top), p] = rows[top]
    return out_s, out_r


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("r", [2, 8])
def test_k6_total_order_matches_jax_kernel(D, r):
    """The TPU kernel's merge of 128-row blocks is a top-r under one total
    order, so K6 may visit rows in any order; duplicates planted within
    and across blocks resolve alike."""
    rng = np.random.default_rng(10 * D + r)
    T, K, nprobe, tpl, groups = 40, 12, 4, 8, 2
    codes, offsets = random_csr(rng, K, D, 300)
    qs = scaled_queries(rng, T, D)
    coarse = rng.normal(size=(T, K)).astype(np.float32)
    sched, _, _, _ = jax_schedule(coarse, nprobe, offsets, tpl, groups, D)
    qidx = np.asarray(sched.qidx)
    # list 2's planted cross-block duplicate (rows b+5, b+140) made the best
    # rows of a member token: both enter its top-r, the later block first
    b = offsets[2]
    t = qidx[2, 0]
    assert t >= 0
    codes[b + 5] = codes[b + 140] = np.where(qs[t] >= 0, 127, -127)
    maxb = (int(np.diff(offsets).max()) + 31 + 127) // 128
    t_pad = -(-T // 128) * 128
    qsT = jnp.pad(jnp.asarray(qs), ((0, t_pad - T), (0, 0))).T
    js, jr = jsp.sq_batch_list_scan(sched.qidx, sched.meta, qsT, pad_codes_for_scan(jnp.asarray(codes), maxb * 128),
                                    tpl=tpl, r=r, interpret=True)
    ts, tr = total_order_topr(qidx, offsets, qs, codes, r)
    ran = np.asarray(sched.meta)[:, 0, 1] > 0
    assert ran[2]
    np.testing.assert_array_equal(tr[2, :2, 0], [b + 140, b + 5])
    np.testing.assert_array_equal(np.asarray(jr)[2, :2, 0], [b + 140, b + 5])
    filled = np.broadcast_to((qidx[ran] >= 0)[:, None, :], ts[ran].shape)
    js = np.where(filled, np.asarray(js)[ran], -np.inf)
    jr = np.where(filled, np.asarray(jr)[ran], -1)
    assert_ranked_match(js, jr, ts[ran], tr[ran], axis=1)


@pytest.mark.parametrize("kind", ["serving", "nothing_filled", "every_list_over_capacity"])
def test_slot_work_list_matches_jax_schedule(kind):
    """K6's work list (route "mma", plain version): the filled slots of the
    JAX schedule's qidx, their count, the most 64-row stages first (counts
    above 15 tie; equal counts in slot order), then the empty slots."""
    T, K, nprobe, tpl, groups = {"serving": (2304, 4096, 128, 128, 8), "nothing_filled": (40, 12, 4, 8, 2),
                                 "every_list_over_capacity": (40, 6, 6, 4, 2)}[kind]
    rng = np.random.default_rng(T + K)
    coarse = rng.normal(size=(T, K)).astype(np.float32)
    lens = rng.integers(0, 160, size=K)
    offsets = np.zeros(K + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    mask = np.zeros(K, bool) if kind == "nothing_filled" else None
    sched, _, vals, lists = jax_schedule(coarse, nprobe, offsets, tpl, groups, 64, mask)
    member = torch.from_numpy(coarse >= vals[:, -1:])
    if mask is not None:
        member &= torch.from_numpy(mask)[None, :]
    got, _ = psp.build_slot_schedule_dense(member, torch.from_numpy(lists), tpl=tpl, groups=groups)
    items, count = psp.slot_work_list(got.qidx, torch.from_numpy(offsets))
    jq = np.asarray(sched.qidx)
    want = np.flatnonzero(jq[:, 0] >= 0)
    n = int(count)
    items = items.numpy()
    assert count.dtype == torch.int32 and count.dim() == 0 and items.dtype == np.int32
    assert items.shape == (groups * K,)
    assert n == len(want) == {"serving": n, "nothing_filled": 0, "every_list_over_capacity": groups * K}[kind]
    np.testing.assert_array_equal(np.sort(items[:n]), want)
    np.testing.assert_array_equal(np.sort(items), np.arange(groups * K))
    key = np.minimum(-(-lens[items[:n] % K] // 64), psp.WORK_BUCKETS - 1)  # 64-row stages of work
    assert (np.diff(key) <= 0).all()
    assert all(items[i] < items[i + 1] for i in range(n - 1) if key[i] == key[i + 1])
    if kind == "serving":
        assert 0 < n < groups * K


@pytest.mark.parametrize("D,tpl,r,ok", [(16, 1, 1, True), (64, 128, 8, True), (128, 7, 16, True),
                                        (48, 8, 2, False), (64, 129, 8, False), (64, 8, 17, False)])
def test_scan_plan_routes_every_k6_shape(D, tpl, r, ok):
    """Route "mma" takes every shape K6 takes (sq_dim 16/32/64/128, tpl
    1..128, r 1..16); any other shape raises before a launch."""
    if ok:
        assert psp.scan_plan(D, tpl, r) == "mma"
    else:
        with pytest.raises(ValueError):
            psp.scan_plan(D, tpl, r)


@pytest.mark.parametrize("r", [2, 8])
def test_k7_plain_matches_jax_kernel(r):
    rng = np.random.default_rng(7 + r)
    T, K, D = 150, 10, 64  # two token tiles of 128
    codes, offsets = random_csr(rng, K, D, 290)
    qs = scaled_queries(rng, T, D)
    hot = np.array([2, 5, -1, 0], np.int32)
    maxb = (int(np.diff(offsets).max()) + 31 + 127) // 128
    t_pad = -(-T // 128) * 128
    qsT = jnp.pad(jnp.asarray(qs), ((0, t_pad - T), (0, 0))).T
    js, jr = jsp.sq_hot_list_scan(jnp.asarray(hot), jnp.asarray(offsets), qsT,
                                  pad_codes_for_scan(jnp.asarray(codes), maxb * 128),
                                  hot_cap=len(hot), maxb=maxb, r=r, interpret=True)
    ps, pr = psp.sq_hot_list_scan(torch.from_numpy(hot), torch.from_numpy(offsets), torch.from_numpy(qs),
                                  torch.from_numpy(codes), r=r)
    assert ps.shape == (len(hot), r, T)
    assert_ranked_match(np.asarray(js)[:, :, :T], np.asarray(jr)[:, :, :T], ps.numpy(), pr.numpy(), axis=1)
    assert not np.isfinite(ps.numpy()[2]).any()  # hot id -1: nothing


def jax_hot_k7(hot, offsets, qs, codes, r):
    """The TPU kernel ``_hot_kernel`` in interpret mode: (H, r, T) numpy."""
    T = qs.shape[0]
    maxb = (int(np.diff(offsets).max()) + 31 + 127) // 128
    t_pad = -(-T // 128) * 128
    qsT = jnp.pad(jnp.asarray(qs), ((0, t_pad - T), (0, 0))).T
    js, jr = jsp.sq_hot_list_scan(jnp.asarray(hot), jnp.asarray(offsets), qsT,
                                  pad_codes_for_scan(jnp.asarray(codes), maxb * 128),
                                  hot_cap=len(hot), maxb=maxb, r=r, interpret=True)
    return np.asarray(js)[:, :, :T], np.asarray(jr)[:, :, :T]


@pytest.mark.parametrize("r", [2, 8])
def test_k7_plain_with_members_matches_jax_kernel(r):
    """K7's plain version over member tokens: equal to the TPU kernel (every
    token) on every member entry, -inf / -1 on every other.  Hot entry 0
    is probed by every token, entry 3 by none, entry 2 is -1."""
    rng = np.random.default_rng(70 + r)
    T, K, D = 150, 10, 64
    codes, offsets = random_csr(rng, K, D, 290)
    qs = scaled_queries(rng, T, D)
    hot = np.array([2, 5, -1, 0, 1], np.int32)  # list 1 is empty
    members = rng.random((T, len(hot))) < 0.4
    members[:, 0], members[:, 3] = True, False
    js, jr = jax_hot_k7(hot, offsets, qs, codes, r)
    ps, pr = psp.sq_hot_list_scan(torch.from_numpy(hot), torch.from_numpy(offsets), torch.from_numpy(qs),
                                  torch.from_numpy(codes), r=r, members=torch.from_numpy(members))
    ps, pr = ps.numpy(), pr.numpy()
    read = np.broadcast_to((members.T & (hot >= 0)[:, None])[:, None, :], ps.shape)
    assert_ranked_match(np.where(read, js, -np.inf), np.where(read, jr, -1), ps, pr, axis=1)
    assert np.isfinite(ps[read]).sum() > 100 * r
    assert not np.isfinite(ps[~read]).any() and (pr[~read] == -1).all()


def jax_membership(coarse, nprobe, hot_cap, tpl, groups):
    """The JAX probe's membership and hot lists (``colbert_tpu/ops/ivf.py``
    ``ivf_probe_sq_batched``): (member (T, K), hot_ids (hot_cap,)) numpy."""
    c = jnp.asarray(coarse)
    vals, _ = jax.lax.top_k(c, nprobe)
    member = c >= vals[:, -1:]
    hot_vals, hot_raw = jax.lax.top_k(member.sum(axis=0), hot_cap)
    return np.asarray(member), np.asarray(jnp.where(hot_vals > groups * tpl, hot_raw, -1)).astype(np.int32)


@pytest.mark.parametrize("T,K,nprobe,hot_cap,cap", [(300, 12, 5, 6, 8), (129, 9, 9, 4, 8), (40, 30, 3, 5, 64)])
def test_hot_member_schedule_matches_jax_membership(T, K, nprobe, hot_cap, cap):
    """K7's slots on route "mma" (plain version): each hot list's member
    tokens of the JAX probe, ascending, 128 a slot, slot g*H + h, -1 past
    the last; and the work list over them (``lmap`` = hot_ids) lists
    exactly the filled slots of real hot lists, most 64-row stages first.
    Cases: hot lists over 128 members (two slots), every list a member of
    every token (129 tokens: a second, one-token slot), no list hot."""
    rng = np.random.default_rng(T + K)
    coarse = rng.normal(size=(T, K)).astype(np.float32)
    member, hot = jax_membership(coarse, nprobe, hot_cap, tpl=cap, groups=1)
    lens = rng.integers(0, 300, size=K)
    offsets = np.zeros(K + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    H, G = len(hot), -(-T // 128)
    want = np.full((G * H, 128), -1, np.int32)
    for h in np.flatnonzero(hot >= 0):
        toks = np.flatnonzero(member[:, hot[h]])
        for i, t in enumerate(toks):
            want[(i // 128) * H + h, i % 128] = t
    members = torch.from_numpy(member[:, np.maximum(hot, 0)])
    hot_t = torch.from_numpy(hot)
    got = psp.hot_member_schedule(hot_t, T, members)
    np.testing.assert_array_equal(got.numpy(), want)
    items, count = psp.slot_work_list(got, torch.from_numpy(offsets), lmap=hot_t)
    filled = np.flatnonzero((want[:, 0] >= 0) & np.tile(hot >= 0, G))
    n = int(count)
    assert n == len(filled) == {300: n, 129: 2 * H, 40: 0}[T]
    np.testing.assert_array_equal(np.sort(items.numpy()[:n]), filled)
    stages = np.minimum(-(-lens[hot[items.numpy()[:n] % H]] // 64), psp.WORK_BUCKETS - 1)
    assert (np.diff(stages) <= 0).all()
    if T == 300:
        assert (want[H:, 0] >= 0).any()  # a hot list with a second slot
    # every token a member: the default schedule
    every = psp.hot_member_schedule(hot_t, T)
    for h in np.flatnonzero(hot >= 0):
        np.testing.assert_array_equal(every.numpy()[h::H].reshape(-1)[:T], np.arange(T))


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e6])
def test_query_terms_sum_back_exactly(scale):
    """K7's B operand: three bf16 terms of fp32 ``qs`` whose fp32 sum is
    ``qs`` exactly (each remainder is exact in fp32); the first is K6's
    bf16 rounding, and each term is at most half a bf16 ulp of the last."""
    rng = np.random.default_rng(int(np.log10(scale)) + 5)
    qs = torch.from_numpy((rng.normal(size=(300, 64)) * scale).astype(np.float32))
    t = psp.query_terms(qs)
    assert t.shape == (3, 300, 64) and t.dtype == torch.bfloat16
    f = t.float()
    assert torch.equal((f[0] + f[1]) + f[2], qs)
    assert torch.equal(t[0], qs.to(torch.bfloat16))
    assert torch.equal(psp.query_terms(qs, terms=1)[0], t[0])
    assert (f[1].abs() <= f[0].abs() * 2.0 ** -8).all() and (f[2].abs() <= f[1].abs() * 2.0 ** -8).all()


def _probe_inputs(seed, T, K, D, dim=32, n_per_list=60):
    """A clustered corpus: codes, offsets and the projection of a real sq index."""
    from colbert_tpu.ops.sq import sq_encode, sq_train

    rng = np.random.default_rng(seed)
    cent = rng.normal(size=(K, dim)).astype(np.float32)
    sizes = rng.integers(1, 2 * n_per_list, size=K)
    sizes[0] = 5 * n_per_list  # a hot, multi-block list
    x = np.concatenate([c + 0.3 * rng.normal(size=(n, dim)) for c, n in zip(cent, sizes)]).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)  # unit rows, as the encoder writes
    assign = np.repeat(np.arange(K), sizes).astype(np.int32)
    proj, scales = sq_train(jnp.asarray(x), D)
    codes = np.asarray(sq_encode(jnp.asarray(x), proj, scales))
    perm, offsets = jivf.sort_by_list(assign, K)
    q = (cent[rng.integers(0, K, size=T)] + 0.5 * rng.normal(size=(T, dim))).astype(np.float32)
    q[:, :] += 0.8 * cent[0]  # pull many tokens towards list 0
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q, cent, np.asarray(proj), np.asarray(scales), codes[perm], offsets


@pytest.mark.parametrize("hot_cap", [0, 3])
@pytest.mark.parametrize("D", [16, 64])
def test_ivf_probe_sq_batched_matches_jax(hot_cap, D):
    T, K, nprobe, depth, r = 96, 24, 6, 20, 2
    q, cent, proj, scales, codes, offsets = _probe_inputs(hot_cap + D, T, K, D)
    kw = dict(nprobe=nprobe, depth=depth, r=r, hot_cap=hot_cap, tpl=8, groups=1)
    maxb = (int(np.diff(offsets).max()) + 31 + 127) // 128
    js, jr = jivf.ivf_probe_sq_batched(
        jnp.asarray(q), jnp.asarray(cent), jnp.asarray(proj), jnp.asarray(scales), jnp.asarray(codes),
        jnp.asarray(offsets), maxb=maxb, interpret=True, **kw)
    ps, pr = pivf.ivf_probe_sq_batched(
        torch.from_numpy(q), torch.from_numpy(cent), torch.from_numpy(proj), torch.from_numpy(scales),
        torch.from_numpy(codes), torch.from_numpy(offsets), **kw)
    assert ps.shape == (T, depth) and pr.dtype == torch.int32
    assert_ranked_match(np.asarray(js), np.asarray(jr), ps.numpy(), pr.numpy(), axis=1)
    # the slot capacity (8) is far below list 0's members: with hot lists
    # every token keeps it, without them most tokens lose it
    head = (pr.numpy() >= offsets[0]) & (pr.numpy() < offsets[1])
    if hot_cap:
        assert head.any(axis=1).mean() > 0.9
    else:
        assert head.any(axis=1).mean() < 0.5


@pytest.mark.parametrize("D", [16, 64])
def test_ivf_probe_sq_batched_members_change_nothing(D):
    """K7 over its member tokens (what ``ivf_probe_sq_batched`` passes)
    gives the probe the same (T, depth) output as K7 over every token: the
    postprocess reads member entries only."""
    T, K, nprobe, depth, r = 96, 24, 6, 20, 2
    q, cent, proj, scales, codes, offsets = (torch.from_numpy(np.array(a)) for a in _probe_inputs(3 + D, T, K, D))
    kw = dict(nprobe=nprobe, tpl=8, hot_cap=3, groups=1)
    ps, pr = pivf.ivf_probe_sq_batched(q, cent, proj, scales, codes, offsets, depth=depth, r=r, **kw)
    plan = pivf.sq_probe_plan(q, cent, proj, scales, **kw)
    assert (plan.hot_ids >= 0).sum() >= 2 and plan.hot_members.shape == (T, 3)
    assert 0 < plan.hot_members.sum() < plan.hot_members.numel()
    out = psp.sq_batch_list_scan(plan.sched.qidx, offsets, plan.qs, codes, r=r)
    every = (plan.hot_pos, *psp.sq_hot_list_scan(plan.hot_ids, offsets, plan.qs, codes, r=r))
    ws, wr = psp.probe_batched_postprocess(plan.sched, *out, plan.lists, depth, plan.pair_valid, hot=every)
    assert torch.equal(ps, ws) and torch.equal(pr, wr)


def _dedup_inputs(seed, B, qv, depth, num_docs):
    rng = np.random.default_rng(seed)
    pids = rng.integers(-1, num_docs, size=(B, qv * depth)).astype(np.int32)
    scores = rng.normal(size=(B, qv * depth)).astype(np.float32)
    scores[pids < 0] = -np.inf
    pids[1] = -1  # a query with no candidate at all
    scores[1] = -np.inf
    return pids, scores


@pytest.mark.parametrize("max_out", [16, 300])
def test_dedup_approx_maxsim_matches_jax(max_out):
    B, qv, depth = 5, 4, 30
    pids, scores = _dedup_inputs(max_out, B, qv, depth, num_docs=50)
    token_ids = np.repeat(np.arange(qv, dtype=np.int32), depth)
    jp, js = jax.vmap(lambda p, s: jivf.dedup_pids_by_approx_maxsim(p, jnp.asarray(token_ids), s, qv, max_out))(
        jnp.asarray(pids), jnp.asarray(scores))
    pp, ps = pivf.dedup_pids_by_approx_maxsim(torch.from_numpy(pids), torch.from_numpy(token_ids),
                                              torch.from_numpy(scores), qv, max_out)
    assert pp.shape == (B, max_out) and pp.dtype == torch.int32
    assert_ranked_match(js, jp, ps.numpy(), pp.numpy(), axis=1)
    assert (pp.numpy()[1] == -1).all()


@pytest.mark.parametrize("max_out", [16, 300])
def test_dedup_by_score_matches_jax(max_out):
    B, qv, depth = 5, 4, 30
    pids, scores = _dedup_inputs(max_out + 1, B, qv, depth, num_docs=50)
    jp, js = jax.vmap(lambda p, s: jivf.dedup_pids_by_score(p, s, max_out))(jnp.asarray(pids), jnp.asarray(scores))
    pp, ps = pivf.dedup_pids_by_score(torch.from_numpy(pids), torch.from_numpy(scores), max_out)
    assert_ranked_match(js, jp, ps.numpy(), pp.numpy(), axis=1)
