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
from colbert_tpu_torch.ops.sq import sq_query
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


# ---- route "fused"'s selection (csrc/sq_token_scan.cu), emulated in torch ----

_DIGITS = ((21, 11), (10, 11), (0, 10))  # (shift, bits) of the kernel's three radix passes


def _order_keys(scores):
    """The kernel's order-preserving uint32 key of each fp32 score, as int64."""
    b = scores.float().view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(b >= 1 << 31, 0xFFFFFFFF - b, b | 1 << 31)


def _key_scores(keys):
    b = torch.where(keys >= 1 << 31, keys & 0x7FFFFFFF, 0xFFFFFFFF - keys)
    return torch.where(b >= 1 << 31, b - (1 << 32), b).int().view(torch.float32)


def _fused_select(scores, depth, path):
    """One token's selection as route "fused" makes it, over its real rows'
    scores (n,) in position order -> (scores, positions) of its top
    min(depth, n), best first.  Radix select of the depth-th largest key
    (stopping when every key of the chosen prefix is taken), every key above
    the prefix, the lowest positions among those equal to it, then one sort
    of the survivors as 64-bit (key, complemented position) values.
    ``path`` collects which branches ran."""
    n = scores.numel()
    key, pos = _order_keys(scores), torch.arange(n)
    if n <= depth:
        taken = pos
        path.add("take all")
    else:
        need, prefix, pshift = depth, None, 32
        for npass, (shift, bits) in enumerate(_DIGITS, 1):
            match = torch.ones(n, dtype=torch.bool) if prefix is None else (key >> pshift) == prefix
            hist = torch.bincount((key[match] >> shift) & ((1 << bits) - 1), minlength=1 << bits)
            at_or_above = hist.flip(0).cumsum(0).flip(0)
            b = int(torch.nonzero(at_or_above >= need).max())
            need_eq, cnt_eq = need - int(at_or_above[b] - hist[b]), int(hist[b])
            prefix = b if prefix is None else (prefix << bits) | b
            pshift, need = shift, need_eq
            if need_eq == cnt_eq:
                break
        path.add(f"{npass} passes")
        gt, eq = (key >> pshift) > prefix, (key >> pshift) == prefix
        if need_eq < cnt_eq:
            path.add("ordered ties")
        taken = torch.cat([pos[gt], pos[eq][:need_eq]])
        assert taken.numel() == depth
    # unsigned 64-bit order of (key << 32 | ~pos), biased into int64
    packed = (key[taken] - (1 << 31)) * (1 << 32) + (0xFFFFFFFF - taken)
    packed = torch.sort(packed, descending=True)[0]
    return _key_scores((packed >> 32) + (1 << 31)), 0xFFFFFFFF - (packed & 0xFFFFFFFF)


def _fused_window_topk(scores, starts, lens, cap, depth, path):
    """:func:`_fused_select` per token over the dense window scores (T,
    nprobe*cap): (scores, rows) as route "fused" writes them."""
    T, nprobe = starts.shape
    out_s = torch.full((T, depth), float("-inf"))
    out_r = torch.full((T, depth), -1, dtype=torch.int32)
    for t in range(T):
        ln = lens[t].clamp(0, cap).long()
        pre = torch.cat([torch.zeros(1, dtype=torch.long), ln.cumsum(0)])
        j = torch.repeat_interleave(torch.arange(nprobe), ln)
        i = torch.arange(int(pre[-1])) - pre[j]
        s, p = _fused_select(scores[t, j * cap + i], depth, path)
        out_s[t, : s.numel()] = s
        out_r[t, : s.numel()] = (starts[t].long()[j[p]] + i[p]).int()
    return out_s, out_r


def _planted_scores(rng, T, nprobe, cap):
    """Dense window scores with the cases the selection must get right."""
    lens = rng.integers(cap // 2, cap + 1, size=(T, nprobe)).astype(np.int32)
    s = rng.integers(-40, 40, size=(T, nprobe * cap)).astype(np.float32) / 4  # exact ties within and across lists
    s[1] = 0.5                                                  # all equal
    s[2] = np.where(rng.random(nprobe * cap) < 0.5, -0.0, 0.0)  # -0.0 beside +0.0 at the threshold
    s[2, ::7] = 1.0
    s[3] = rng.normal(size=nprobe * cap).astype(np.float32)     # distinct: three radix passes
    s[4] = 1.0
    real = (np.arange(nprobe)[:, None] * cap + np.arange(cap // 2)).reshape(-1)  # inside every window
    s[4, rng.choice(real, size=40, replace=False)] = 1024.0  # one top digit bin holds them: one pass at depth 40
    lens[5] = 0
    lens[5, 2] = 7                                              # fewer real rows than depth
    lens[6, ::2] = 0                                            # empty lists
    s = np.where(np.arange(cap) < lens[..., None], s.reshape(T, nprobe, cap), -np.inf).reshape(T, -1)
    starts = rng.integers(0, 10_000, size=(T, nprobe)).astype(np.int32)
    return torch.from_numpy(s.astype(np.float32)), torch.from_numpy(starts), torch.from_numpy(lens)


@pytest.mark.parametrize("depth", [1, 40, 200, 5000])
def test_fused_selection_emulation_matches_topk_first(depth):
    """The kernel's selection (keys, radix digits, threshold, lowest-position
    ties, 64-bit sort), emulated, against ``topk_first`` over the dense
    window scores, element for element; depth 5000 passes nprobe * cap."""
    T, nprobe, cap = 9, 6, 300
    scores, starts, lens = _planted_scores(np.random.default_rng(depth), T, nprobe, cap)
    path = set()
    got_s, got_r = _fused_window_topk(scores, starts, lens, cap, depth, path)
    want_s, want_r = psq._window_topk(scores, starts, cap, depth)
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))  # -0.0 apart from +0.0
    assert torch.equal(got_r, want_r)
    want_paths = {1: {"1 passes", "3 passes", "ordered ties"},
                  40: {"take all", "1 passes", "2 passes", "3 passes", "ordered ties"},
                  200: {"take all", "ordered ties"}, 5000: {"take all"}}[depth]
    assert want_paths <= path, path


@pytest.mark.parametrize("D,depth", [(16, 20), (64, 300), (32, 150)])
def test_sq_window_topk_matches_jax_pallas_path(D, depth):
    """``sq_window_topk`` (the plain version on the CPU) on the port's own
    windows against the JAX package's Pallas probe, planted ties included;
    and equal, element for element, to route "staged"'s composition."""
    T, K, nprobe = 40, 12, 4
    q, cent, proj, scales, codes, offsets, tied = _probe_inputs(D + 1, T, K, D)
    cap = int(np.diff(offsets).max())
    js, jr = jivf.ivf_probe_sq(jnp.asarray(q), jnp.asarray(cent), jnp.asarray(proj), jnp.asarray(scales),
                               jnp.asarray(codes), jnp.asarray(offsets), nprobe=nprobe, cap=cap, depth=depth,
                               token_chunk=min(32, T), use_pallas=True)
    t_off = torch.from_numpy(offsets)
    lists = pivf.coarse_lists(torch.from_numpy(q), torch.from_numpy(cent), nprobe)
    starts = t_off[lists]
    lens = (t_off[lists + 1] - starts).clamp(max=cap)
    qs = sq_query(torch.from_numpy(q), torch.from_numpy(proj), torch.from_numpy(scales))
    codes_t = torch.from_numpy(codes)
    ps, pr = psq.sq_window_topk(starts, lens, qs, codes_t, cap=cap, depth=depth)
    assert ps.shape == (T, depth) and pr.dtype == torch.int32
    err, bad = ranked_mismatch(torch.from_numpy(np.asarray(js)), torch.from_numpy(np.asarray(jr)), ps, pr, TOL)
    assert err <= TOL and bad == 0, (err, bad)
    assert sorted(pr.numpy()[0, :3].tolist()) == sorted(tied)
    ss, sr = psq._window_topk(psq.sq_list_scan(starts, lens, qs, codes_t, cap=cap), starts, cap, depth)
    assert torch.equal(ps, ss) and torch.equal(pr, sr)


def test_sq_window_topk_plan_and_routes():
    """Route "fused" for every sq_dim and depth up to its limit, "staged"
    deeper; an unknown sq_dim or route raises."""
    for D in (16, 32, 64, 128):
        assert psq.sq_window_topk_plan(D, 512) == "fused"
        assert psq.sq_window_topk_plan(D, psq.FUSED_MAX_DEPTH) == "fused"
        assert psq.sq_window_topk_plan(D, psq.FUSED_MAX_DEPTH + 1) == "staged"
    with pytest.raises(ValueError):
        psq.sq_window_topk_plan(48, 512)
    z = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        psq.sq_window_topk(z, z, torch.zeros(2, 16), torch.zeros((5, 16), dtype=torch.int8), cap=4, depth=8,
                           route="dense")


def test_ranked_mismatch_excuses_a_tie_run_across_a_near_tie():
    """Rows C (x + d) and A (x), each twice (two windows over one list): the
    plain side ranks C, C, A, A; the kernel's sums tie all four, so it ranks
    them by column, A, C, A, C.  Adjacent near ties excuse only ranks 2-3;
    with both sides' scores of the other side's rows every rank is a near
    tie.  A row whose score is off by more than the limit still counts."""
    x, d = 0.5, 2e-6
    ws = torch.tensor([[x + d, x + d, x, x]])
    wr = torch.tensor([[7, 7, 3, 3]], dtype=torch.int32)
    gs = torch.full((1, 4), x)
    gr = torch.tensor([[3, 7, 3, 7]], dtype=torch.int32)
    got_at_want = torch.full((1, 4), x)
    want_at_got = torch.tensor([[x, x + d, x, x + d]])
    assert ranked_mismatch(ws, wr, gs, gr, TOL, got_at_want)[1] == 2
    assert ranked_mismatch(ws, wr, gs, gr, TOL, got_at_want, want_at_got)[1] == 0
    gr[0, 3], want_at_got[0, 3] = 9, x - 1.0
    assert ranked_mismatch(ws, wr, gs, gr, TOL, got_at_want, want_at_got)[1] == 1
