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
from rerank_edges import EDGES, edge_cand  # tests/rerank_edges.py: pytest puts tests/ on the path

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
    (40, 112, 128, 3, 32, 130),  # a ragged corpus's bucket: stride 112 rows, 32 query rows
    (30, 20, 128, 2, 32, 100),   # rows a doc not a multiple of 16 (route "wgmma_rows"'s zero-filled tile)
    # dims that are not whole 64-dim chunks, nor multiples of 16 (the TPU kernel takes any dim; the
    # TinyBERT-4L-zh width's dim = hidden is 312): routes "wgmma" (16 x 16) and "wgmma_rows" on the card
    (50, 16, 24, 3, 16, 150),
    (50, 16, 100, 3, 16, 150),
    (60, 16, 312, 3, 16, 200),
    (30, 20, 312, 2, 32, 100),
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
    (30, 64, 128, 2, 32, 130),  # a ragged corpus's int8 bucket: stride 64 rows, 32 query rows
    (20, 40, 512, 2, 32, 100),  # rows a doc not a multiple of 16; (dim/128)*dv = 160, as the packing needs
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


# ---- the "wgmma" route's pid-window schedule (kernel-free: its plain walker) ----

@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("kind", EDGES)
def test_windowed_walk_matches_plain_and_jax_kernel(kind, table_dtype):
    """The "wgmma" route's schedule walked in plain torch (windows of 7 docs,
    groups of 8) against ``_rerank_ref`` and the TPU kernel in interpret
    mode, on the route's shape (16 rows a doc, 16 views), within 1e-4."""
    B, C, dv, qv, dim = 4, (77 if kind == "C = 77" else 40), 16, 16, 256
    num_docs = B * C + 3 if kind == "all distinct" else 50
    rng = np.random.default_rng(EDGES.index(kind))
    emb, Qm, _ = _case(EDGES.index(kind) + 100, num_docs, dv, dim, B, qv, C)
    cand = edge_cand(kind, rng, num_docs, B, C)
    assert prr.rerank_plan(dv, qv, dim) == "wgmma"
    if table_dtype == "int8":
        q8, scale = prr.quantize_emb_table(emb)
        Qm = Qm * (1.0 / scale).astype(np.float32)
        table, q = torch.from_numpy(q8), torch.from_numpy(Qm)
        want = np.asarray(jrp.maxsim_rerank_uniform_packed(
            jnp.asarray(_pad128(cand)), jnp.asarray(Qm), jnp.asarray(jrp.pack_int8_table(q8, dv)),
            dv=dv, nk=dim // 128, interpret=True))[:, :C]
    else:
        table = torch.from_numpy(emb).to(torch.bfloat16)
        q = torch.from_numpy(Qm).to(torch.bfloat16).float()   # the kernel's bf16 operand
        want = np.asarray(jrp.maxsim_rerank_uniform(
            jnp.asarray(_pad128(cand)), jnp.asarray(Qm), jnp.asarray(emb.astype(np.float32), jnp.bfloat16),
            dv=dv, interpret=True))[:, :C]
    c = torch.from_numpy(cand)
    got = prr.rerank_windowed_ref(c, q, table, dv, window=7).numpy()
    plain = prr._rerank_ref(c, q, table, dv).numpy()
    live = cand >= 0
    np.testing.assert_array_equal(np.isfinite(got), live)
    assert np.isneginf(got[~live]).all() and np.isneginf(want[~live]).all()
    np.testing.assert_allclose(got[live], plain[live], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=TOL)


@pytest.mark.parametrize("table_dtype,dv,dim", [
    ("bfloat16", 20, 128),   # rows a doc not a multiple of 16: two tiles, the last 4 rows of 16
    ("int8", 24, 512),       # the same for K5, in a shape the JAX int8 table's packing takes
])
@pytest.mark.parametrize("kind", EDGES)
def test_rows_walk_matches_plain_and_jax_kernel(kind, table_dtype, dv, dim):
    """The "wgmma_rows" route's work list walked in plain torch (windows of
    7 docs, parts of at most 3 docs, groups of 8, 16-row tiles with the max
    carried between them) at 32 query rows against ``_rerank_ref`` and the
    TPU kernel in interpret mode, within 1e-4; -inf exactly at the -1
    candidates, a query with none included ("all -1 row")."""
    B, C, qv = 3, (77 if kind == "C = 77" else 40), 32
    num_docs = B * C + 3 if kind == "all distinct" else 40
    rng = np.random.default_rng(EDGES.index(kind) + dv)
    emb, Qm, _ = _case(EDGES.index(kind) + 200, num_docs, dv, dim, B, qv, C)
    cand = edge_cand(kind, rng, num_docs, B, C)
    assert prr.rerank_plan(dv, qv, dim) == "wgmma_rows"
    if table_dtype == "int8":
        q8, scale = prr.quantize_emb_table(emb)
        Qm = Qm * (1.0 / scale).astype(np.float32)
        table, q = torch.from_numpy(q8), torch.from_numpy(Qm)
        want = np.asarray(jrp.maxsim_rerank_uniform_packed(
            jnp.asarray(_pad128(cand)), jnp.asarray(Qm), jnp.asarray(jrp.pack_int8_table(q8, dv)),
            dv=dv, nk=dim // 128, interpret=True))[:, :C]
    else:
        table = torch.from_numpy(emb).to(torch.bfloat16)
        q = torch.from_numpy(Qm).to(torch.bfloat16).float()   # the kernel's bf16 operand
        want = np.asarray(jrp.maxsim_rerank_uniform(
            jnp.asarray(_pad128(cand)), jnp.asarray(Qm), jnp.asarray(emb.astype(np.float32), jnp.bfloat16),
            dv=dv, interpret=True))[:, :C]
    c = torch.from_numpy(cand)
    got = prr.rerank_rows_ref(c, q, table, dv, window=7, part=3).numpy()
    plain = prr._rerank_ref(c, q, table, dv).numpy()
    live = cand >= 0
    np.testing.assert_array_equal(np.isfinite(got), live)
    assert np.isneginf(got[~live]).all() and np.isneginf(want[~live]).all()
    np.testing.assert_allclose(got[live], plain[live], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=TOL)


@pytest.mark.parametrize("part", [1, 3, 32])
def test_rows_items_cover_each_candidate_once(part):
    """The "wgmma_rows" work list: every real candidate's sorted index in
    exactly one item, of its own query and inside one (window, query) run;
    no item empty or longer than ``part``; window-major; the rows past the
    last item all -1; its length fixed by the shapes."""
    rng = np.random.default_rng(part)
    B, C, num_docs, window = 5, 33, 60, 8
    cand = edge_cand("duplicate pids", rng, num_docs, B, C)
    cand[2] = -1
    spid, perm, wstart = prr.rerank_schedule(torch.from_numpy(cand), num_docs, window)
    items = prr.rerank_items(wstart, C, part)
    n_win = wstart.shape[1] - 1
    assert items.dtype == torch.int32 and items.shape == (B * C // part + min(n_win * B, B * C), 3)
    live = int((items[:, 0] >= 0).sum())
    assert (items[live:, 0] == -1).all() and (items[:live, 0] >= 0).all()
    seen = np.zeros((B, C), np.int64)
    last = (-1, -1)
    for b, lo, hi in items[:live].tolist():
        assert 0 < hi - lo <= part
        w = int(spid[b, lo]) // window
        assert w == int(spid[b, hi - 1]) // window and int(wstart[b, w]) <= lo and hi <= int(wstart[b, w + 1])
        assert (w, b) >= last  # window-major, then query
        last = (w, b)
        seen[b, lo:hi] += 1
    for b in range(B):
        n = int((cand[b] >= 0).sum())
        assert (seen[b, :n] == 1).all() and (seen[b, n:] == 0).all()


def test_schedule_covers_each_candidate_once():
    """Every real candidate lies in exactly one item, in the window of its
    pid; -1s in none; ``perm`` is a permutation of each row."""
    rng = np.random.default_rng(3)
    cand = edge_cand("duplicate pids", rng, 60, 5, 33)
    cand[2] = -1
    spid, perm, wstart = prr.rerank_schedule(torch.from_numpy(cand), 60, 8)
    assert spid.dtype == wstart.dtype == torch.int32 and wstart.shape == (5, 9)
    for b in range(5):
        assert sorted(perm[b].tolist()) == list(range(33))
        np.testing.assert_array_equal(spid[b].numpy(), np.where(cand[b] < 0, 2**31 - 1, cand[b])[perm[b].numpy()])
        assert int(wstart[b, 0]) == 0 and int(wstart[b, -1]) == int((cand[b] >= 0).sum())
        for w in range(8):
            items = spid[b, wstart[b, w] : wstart[b, w + 1]]
            assert ((items >= 8 * w) & (items < 8 * (w + 1))).all()


def _plan_cases(cases):
    """(dv, qv, dim, int8, route) cases; a bf16 one keeps the id of its values
    without ``int8``, an int8 one adds "int8", but where marked as an old
    case whose check the int8 table keeps."""
    out = []
    for (dv, qv, dim, int8, route, *old) in cases:
        name = f"{dv}-{qv}-{dim}-{route}" if not int8 or old else f"{dv}-{qv}-{dim}-int8-{route}"
        out.append(pytest.param(dv, qv, dim, int8, route, id=name))
    return out


@pytest.mark.parametrize("dv,qv,dim,int8,route", _plan_cases([
    (16, 16, 768, False, "wgmma"),        # the serving point (and the first card case)
    (37, 32, 128, False, "wgmma_rows"),   # the card cases of test_torch_kernels.py
    (5, 3, 32, True, "staged", "old"),    # int8 dim 32: not a whole 64-dim chunk
    (5, 3, 32, False, "wgmma_rows"),      # bf16: any dim, by the producers' copies
    (5, 3, 64, False, "wgmma_rows"),
    (16, 16, 80, True, "staged", "old"),  # int8 dim not whole 64-dim stages
    (16, 16, 80, False, "wgmma"),
    (16, 16, 312, False, "wgmma"),        # the TinyBERT-4L-zh width's dim = hidden at the serving shape
    (20, 16, 312, False, "wgmma_rows"),
    (16, 16, 312, True, "staged"),
    (16, 16, 1024, False, "wgmma"),       # the wgmma routes' widest
    (16, 16, 1030, False, "staged"),      # past it
    (16, 16, 2048, False, "staged"),      # dim past the wgmma routes' shared-memory budget
    (16, 32, 768, False, "wgmma_rows"),
    (16, 8, 768, False, "wgmma_rows"),
    (64, 32, 768, False, "wgmma_rows"),   # ragged stride buckets
    (384, 32, 768, False, "wgmma_rows"),  # doc_maxlen 384's largest bucket
    (124, 32, 768, False, "wgmma_rows"),  # a host table's cap: the longest doc
    (124, 33, 768, False, "staged"),      # past one launch's rows (row_chunk cuts them first)
    (16, 16, 768, True, "wgmma"),
]))
def test_rerank_plan_routes(dv, qv, dim, int8, route):
    assert prr.rerank_plan(dv, qv, dim, int8) == route


@pytest.mark.parametrize("dv,qv,dim,chunk,route,int8", [pytest.param(*c, False, id="-".join(map(str, c))) for c in (
    (16, 16, 768, 16, "wgmma"), (16, 8, 768, 8, "wgmma_rows"),     # one launch, as rerank_plan routes it
    (16, 17, 768, 16, "wgmma"), (16, 48, 768, 16, "wgmma"),        # the "wgmma" shape past 16 rows: 16-row chunks
    (37, 32, 128, 32, "wgmma_rows"),                               # up to 32 rows: one launch
    (37, 33, 128, 32, "wgmma_rows"), (16, 64, 2048, 32, "staged"),  # past 32 rows: 32-row chunks
    (124, 48, 768, 32, "wgmma_rows"),                              # a host table's cap at 48 rows
    (16, 48, 312, 16, "wgmma"), (16, 48, 1030, 32, "staged"),      # bf16 dims that are not whole chunks
)] + [pytest.param(16, 32, 80, 32, "staged", True, id="16-32-80-32-staged")])  # int8 at dim 80: K5's "staged"
def test_row_chunk_sizes(dv, qv, dim, chunk, route, int8):
    assert prr.row_chunk(dv, qv, dim, int8) == chunk
    assert prr.rerank_plan(dv, chunk, dim, int8) == route


@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("qv", [17, 33, 48, 64])
@pytest.mark.parametrize("dv,dim", [(16, 256), (32, 128)])  # (dim / 128) * dv = 32: the JAX int8 table's packing
def test_row_chunks_sum_to_the_unchunked_plain_version(qv, table_dtype, dv, dim):
    """``sum_row_chunks`` with K4's or K5's plain version as the scorer, in
    :func:`row_chunk`'s chunks (16 rows, the last padded with zero rows, on
    the "wgmma" shape; 32 elsewhere), against the plain version over all
    the rows and against the TPU kernel in interpret mode, within 1e-4;
    -inf exactly at the -1 candidates.  17 rows off the "wgmma" shape are
    one launch, one chunk."""
    B, C, num_docs = 3, 90, 60
    emb, Qm, cand = _case(qv * dv, num_docs, dv, dim, B, qv, C)
    chunk = prr.row_chunk(dv, qv, dim)
    assert chunk == (16 if dv == 16 else min(qv, 32))
    if table_dtype == "int8":
        q8, scale = prr.quantize_emb_table(emb)
        table, Qm = torch.from_numpy(q8), Qm * (1.0 / scale).astype(np.float32)
        ref = prr.maxsim_rerank_uniform_int8_ref
        want = np.asarray(jrp.maxsim_rerank_uniform_packed(
            jnp.asarray(_pad128(cand)), jnp.asarray(Qm), jnp.asarray(jrp.pack_int8_table(q8, dv)),
            dv=dv, nk=dim // 128, interpret=True))[:, :C]
    else:
        table, ref = torch.from_numpy(emb).to(torch.bfloat16), prr.maxsim_rerank_uniform_ref
        want = np.asarray(jrp.maxsim_rerank_uniform(
            jnp.asarray(_pad128(cand)), jnp.asarray(Qm), jnp.asarray(emb.astype(np.float32), jnp.bfloat16),
            dv=dv, interpret=True))[:, :C]
    c, q = torch.from_numpy(cand), torch.from_numpy(Qm)
    widths = []

    def score(rows):
        widths.append(rows.shape[1])
        return ref(c, rows, table, dv=dv)
    got = prr.sum_row_chunks(q, chunk, score, pad=dv == 16)
    if dv == 16:
        assert widths == [16] * -(-qv // 16)
    else:
        assert sum(widths) == qv and widths[:-1] == [32] * (len(widths) - 1)
    plain = ref(c, q, table, dv=dv).numpy()
    got = got.numpy()
    live = cand >= 0
    assert (~live).any() and np.isneginf(got[~live]).all() and np.isfinite(got[live]).all()
    np.testing.assert_allclose(got[live], plain[live], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=TOL)


def test_window_sizes():
    """About two windows of doc blocks in half the 50 MB L2 at the 20k-doc
    serving point (bf16 24 KB a doc, int8 12 KB); at 200k docs no more than
    C / 32 windows."""
    assert prr.window_docs(20_000, 4096, 16 * 768 * 2) == 500
    assert prr.window_docs(20_000, 4096, 16 * 768) == 1000
    assert prr.window_docs(200_000, 4096, 16 * 768 * 2) == 1563
    assert prr.window_docs(10, 77, 16 * 768 * 2) == 10


def test_query_operand_terms_sum_to_the_query():
    """The int8 operand's three bf16 terms sum to the fp32 query once each
    16-dim block's kernel order is undone; the bf16 operand is bf16(Q)."""
    rng = np.random.default_rng(0)
    Qm = torch.from_numpy(rng.normal(size=(3, 16, 64)).astype(np.float32) * 37.0)
    ops = prr.query_operand(Qm, int8_table=True)
    assert ops.shape == (3, 48, 64) and ops.dtype == torch.bfloat16
    assert sorted(prr.INT8_K_ORDER) == list(range(16))
    undo = torch.from_numpy(np.argsort(prr.INT8_K_ORDER))
    terms = ops.float().view(3, 3, 16, 4, 16).index_select(4, undo).view(3, 3, 16, 64)
    torch.testing.assert_close(terms[:, 0] + terms[:, 1] + terms[:, 2], Qm, rtol=2 ** -23, atol=0)
    assert torch.equal(terms[:, 0], Qm.to(torch.bfloat16).float())
    assert torch.equal(prr.query_operand(Qm, int8_table=False), Qm.to(torch.bfloat16))


def test_quantize_into_a_device_buffer_equals_the_table(monkeypatch):
    """``quantize_emb_into`` (the searcher's int8 tables, computed on its
    device into any buffer) gives ``quantize_emb_table``'s values, and the
    descale the searcher takes from it equals the JAX package's ``1/scale``."""
    import colbert_tpu.native.lib as native

    monkeypatch.setattr(native, "_load", lambda: None)
    rng = np.random.default_rng(4)
    emb = (rng.normal(size=(300, 64)) * rng.random(64)).astype(np.float16)
    out = torch.empty(emb.shape, dtype=torch.int8)
    scale = prr.quantize_emb_into(emb, out, chunk=37)
    want_q, want_s = jrp.quantize_emb_table(emb)
    np.testing.assert_array_equal(out.numpy(), want_q)
    np.testing.assert_array_equal((torch.ones_like(scale) / scale).numpy(), (1.0 / want_s).astype(np.float32))
