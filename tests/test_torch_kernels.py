"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the flat scan (K1, K2), all-pairs MaxSim (K3, both routes), dropout (K9, both routes), flash
attention (K11 forward, K12 dK/dV and K13 dQ on both routes, the backward's rows kernel, and their
launches a train and a CE step), the embeddings' backward (the same bits every run, the
process-wide deterministic-algorithms flag untouched), the rerank
(K4 bf16, K5 int8, on both routes, its pid-window schedule's edges and its
freedom from host synchronisation), the sq list scans (K6 slots and K7 hot
lists, each on both routes; K6's work list's edges, K7's member-token
slots, and the probe's freedom from host synchronisation), the pq4 list scan (K8 on both routes, its work list and its
freedom from host synchronisation) and the token-major sq window scan (K10).

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU and
skips elsewhere.  This file imports no jax (the card's machine has none);
run it there without the JAX test harness:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Limits: fp32 scores within 1e-4 of the plain version (bf16 x bf16 products
are exact in fp32; only the summation order differs); bf16 stored scores
within one bf16 ulp of the value, or 1e-4 near zero, where the fp32
summation-order error exceeds a bf16 ulp.
"""

import numpy as np
import pytest
import torch

from colbert_tpu_torch.ops import flat_scan as fs
from rerank_edges import EDGES, edge_cand  # tests/rerank_edges.py: pytest puts tests/ on the path

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    return torch.device("cuda")


def _case(device, num_docs, dv, h, B, m, dtype, seed):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(num_docs * dv, h)).astype(np.float16) / np.sqrt(h)
    table, inv, dv = fs.build_flat_table(emb, np.full(num_docs, dv), dtype=dtype)
    Qm = rng.normal(size=(B, m, h)).astype(np.float32) / np.sqrt(h)
    Qm[0, m // 2 :] = 0.0  # masked views
    Qm = torch.from_numpy(Qm)
    if inv is not None:
        Qm = Qm * inv
    return table.to(device), Qm.to(device), dv


def _bf16_limit(a, b):
    """One bf16 ulp (8 significant bits) at the larger of |a|, |b|, at least 1e-4."""
    ax = torch.maximum(a.float().abs(), b.float().abs()).clamp_min(torch.finfo(torch.float32).tiny)
    _, e = torch.frexp(ax)
    return torch.ldexp(torch.ones_like(ax), e - 8).clamp_min(1e-4)


# (num_docs, dv, h, B, m, table dtype).  Route "wgmma" (dv 16, m 16): the
# main shape; partial last query tiles (B 33, B 1; 16 queries a tile) and
# row tiles (num_docs - 3 ends inside an 8-doc tile); h 128 and 80 (K not a
# multiple of the 64-dim stage); int8 tables.  Route "staged": dv 1, 5, 37,
# 64 and 384 (a doc over several 64-row tiles), m 32.
CASES = [
    (2000, 16, 768, 144, 16, "bfloat16"),
    (1001, 16, 768, 33, 16, "bfloat16"),
    (500, 16, 768, 1, 16, "bfloat16"),
    (997, 16, 768, 33, 16, "int8"),
    (800, 16, 128, 40, 16, "bfloat16"),
    (600, 16, 80, 20, 16, "bfloat16"),
    (500, 16, 80, 17, 16, "int8"),
    (300, 16, 256, 10, 32, "bfloat16"),
    (3000, 1, 128, 9, 16, "bfloat16"),
    (301, 37, 768, 20, 16, "bfloat16"),
    (120, 64, 256, 12, 16, "int8"),
    (40, 384, 128, 5, 16, "bfloat16"),
    (150, 5, 128, 7, 32, "bfloat16"),
]


def _assert_kernels_match_plain(Qm, table, dv, num_docs):
    """K2, K1 fp32 and K1 bf16 against their plain versions, each on the
    route :func:`flat_scan_plan` names and no other."""
    route = fs.flat_scan_plan(dv, Qm.shape[1])
    before = {k: c.value for k, c in fs.route_launches.items()}
    want = fs.flat_maxsim_scan_ref(Qm, table, dv=dv)
    got = fs.flat_maxsim_scan(Qm, table, dv=dv)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)

    s, g = fs.flat_scan_fused(Qm, table, dv=dv, num_docs=num_docs, score_dtype="float32")
    rs, rg = fs.flat_scan_fused_ref(Qm, table, dv=dv, num_docs=num_docs, score_dtype="float32")
    torch.testing.assert_close(s, rs, rtol=0, atol=1e-4)
    torch.testing.assert_close(g, rg, rtol=0, atol=1e-4)

    s, g = fs.flat_scan_fused(Qm, table, dv=dv, num_docs=num_docs, score_dtype="bfloat16")
    rs, rg = fs.flat_scan_fused_ref(Qm, table, dv=dv, num_docs=num_docs, score_dtype="bfloat16")
    assert s.dtype == torch.bfloat16
    fin = torch.isfinite(rs)
    assert torch.equal(fin, torch.isfinite(s))
    assert ((s.float() - rs.float())[fin].abs() <= _bf16_limit(s, rs)[fin]).all()
    gfin = torch.isfinite(rg)  # a group wholly past num_docs holds -inf
    assert torch.equal(gfin, torch.isfinite(g))
    assert ((g - rg)[gfin].abs() <= _bf16_limit(g, rg)[gfin]).all()
    after = {k: c.value for k, c in fs.route_launches.items()}
    assert after == {k: v + 3 * (k == route) for k, v in before.items()}


@pytest.mark.parametrize("num_docs,dv,h,B,m,dtype", CASES)
def test_kernels_match_plain(cuda_device, num_docs, dv, h, B, m, dtype):
    table, Qm, dv = _case(cuda_device, num_docs, dv, h, B, m, dtype, seed=num_docs)
    _assert_kernels_match_plain(Qm, table, dv, num_docs - 3)


def test_main_shape_takes_the_register_epilogue_route(cuda_device):
    table, Qm, dv = _case(cuda_device, 2000, 16, 768, 144, 16, "bfloat16", seed=11)
    before = {k: c.value for k, c in fs.route_launches.items()}
    fs.flat_scan_fused(Qm, table, dv=dv, num_docs=2000, score_dtype="bfloat16")
    torch.cuda.synchronize()
    assert {k: c.value - before[k] for k, c in fs.route_launches.items()} == {"wgmma": 1, "staged": 0}


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_table_view_at_an_aligned_offset(cuda_device, dtype):
    """A table that starts 16 bytes past 128-byte alignment, inside a larger
    allocation (the tensor maps need only 16-byte aligned bases)."""
    table, Qm, dv = _case(cuda_device, 700, 16, 256, 20, 16, dtype, seed=5)
    off = 16 // table.element_size()
    flat = torch.zeros(table.numel() + off, dtype=table.dtype, device=cuda_device)
    view = flat[off:].view(table.shape)
    view.copy_(table)
    assert view.data_ptr() % 16 == 0 and view.data_ptr() % 128 and view.is_contiguous()
    _assert_kernels_match_plain(Qm, view, dv, 697)


def test_topk_on_card_matches_plain(cuda_device):
    table, Qm, dv = _case(cuda_device, 1500, 16, 768, 144, 16, "bfloat16", seed=9)
    k1_before = fs.flat_scan_fused.launches.value
    ts, tp = fs.flat_scan_topk(Qm, table, dv=dv, num_docs=1490, topk=100, score_dtype="float32")
    assert fs.flat_scan_fused.launches.value == k1_before + 1
    full = fs.flat_maxsim_scan_ref(Qm, table, dv=dv)[:1490].T
    want, _ = torch.topk(full, 100, dim=1)
    torch.testing.assert_close(ts, want, rtol=0, atol=1e-4)
    assert ((tp >= 0) & (tp < 1490)).all()
    torch.testing.assert_close(full.gather(1, tp.long()), ts, rtol=0, atol=1e-4)


def test_queries_off_16_byte_alignment(cuda_device):
    """A bf16 query view that starts mid-allocation is copied, not misread."""
    table, Qm, dv = _case(cuda_device, 200, 16, 128, 9, 16, "bfloat16", seed=3)
    flat = torch.empty(Qm.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    view = flat[1:].view(Qm.shape)
    view.copy_(Qm)
    assert view.data_ptr() % 16
    torch.testing.assert_close(fs.flat_maxsim_scan(view, table, dv=dv),
                               fs.flat_maxsim_scan_ref(view, table, dv=dv), rtol=0, atol=1e-4)


def test_kernel_rejects_unsupported_shapes(cuda_device):
    table = torch.zeros(64, 24, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 16"):
        fs.flat_maxsim_scan(torch.zeros(2, 4, 24, device=cuda_device), table, dv=4)
    table = torch.zeros(64, 32, dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="bf16 or int8"):
        fs.flat_maxsim_scan(torch.zeros(2, 4, 32, device=cuda_device), table, dv=4)


# ---- K3: all-pairs MaxSim (fp32), limit 1e-4: fp32 products, only the summation order differs ----

@pytest.mark.parametrize("nq,m,nd,n,h", [
    (34, 16, 340, 16, 768),   # the eval step at the reference batch (multiview): route tf32
    (34, 16, 333, 16, 768),   # a ragged doc count (the last 8-doc tile partial)
    (13, 16, 9, 16, 100),     # h not a multiple of the 32-wide k-tile, one doc tile, two query tiles
    (1, 16, 1, 16, 4),        # one pair, one k-step
    (5, 32, 37, 384, 128),    # multiview off: token-wise doc masks, n = doc_maxlen: route staged
    (3, 70, 11, 5, 33),       # more query rows than one 64-row chunk, odd h
    (3, 1, 200, 1, 8),        # one-row queries and docs: 64 of each per block
    (2, 1024, 50, 1, 32),     # one long query per block: room for the maxima of 48 docs, not 64
    (4, 16, 6, 16, 30),       # m = n = 16 with h not a multiple of 4: route staged
])
def test_maxsim_kernel_matches_plain(cuda_device, nq, m, nd, n, h):
    """The wrapper on the route maxsim_plan picks (one launch counted on
    it, "tf32" for m = n = 16 and h a multiple of 4), and route "staged" on
    the same input, each against the fp32 plain version within 1e-4."""
    from colbert_tpu_torch.ops import maxsim as ms

    rng = np.random.default_rng(nq * nd)
    Q = torch.from_numpy((rng.normal(size=(nq, m, h)) / np.sqrt(h)).astype(np.float32)).to(cuda_device)
    D = torch.from_numpy((rng.normal(size=(nd, n, h)) / np.sqrt(h)).astype(np.float32)).to(cuda_device)
    qm = torch.from_numpy((rng.random((nq, m)) < 0.8).astype(np.int32)).to(cuda_device)
    dm = torch.from_numpy((rng.random((nd, n)) < 0.7).astype(np.int32)).to(cuda_device)
    D[0] = -D[0].abs()  # all-negative doc: its masked rows (0) win the max
    route = ms.maxsim_plan(m, n, h)
    assert route == ("tf32" if m == n == 16 and h % 4 == 0 else "staged")
    before = ms.maxsim.launches.value, {k: c.value for k, c in ms.route_launches.items()}
    got = ms.maxsim(Q, D, qm, dm)
    staged = ms._launch(*ms._apply_masks(Q, D, qm, dm), route="staged")
    torch.cuda.synchronize()
    assert ms.maxsim.launches.value == before[0] + 1
    assert {k: c.value - before[1][k] for k, c in ms.route_launches.items()} == (
        {"tf32": 1, "staged": 1} if route == "tf32" else {"tf32": 0, "staged": 2})
    want = ms.maxsim_ref(Q, D, qm, dm)
    assert got.shape == (nq, nd) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(staged, want, rtol=0, atol=1e-4)


def test_maxsim_tf32_route_agrees_to_fp32_rounding(cuda_device):
    """Route "tf32" at the eval shape, unmasked unit rows: three TF32
    products, each k-tile summed apart, keep fp32 agreement (within 2e-6
    over 16 summed maxima; one TF32 product would be ~2e-4 off, one
    accumulator over the whole dot ~7e-6), and it refuses a shape it does
    not take."""
    from colbert_tpu_torch.ops import maxsim as ms

    g = torch.Generator(cuda_device).manual_seed(3)
    Q = torch.nn.functional.normalize(torch.randn(34, 16, 768, device=cuda_device, generator=g), dim=-1)
    D = torch.nn.functional.normalize(torch.randn(340, 16, 768, device=cuda_device, generator=g), dim=-1)
    got = ms._launch(Q, D, route="tf32")
    torch.testing.assert_close(got, ms.maxsim_ref(Q, D), rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="does not take"):
        ms._launch(Q[:, :8], D, route="tf32")


def test_maxsim_kernel_refuses_a_query_beyond_a_block(cuda_device):
    from colbert_tpu_torch.ops import maxsim as ms

    Q, D = torch.zeros(1, 60000, 4, device=cuda_device), torch.zeros(2, 3, 4, device=cuda_device)
    with pytest.raises(RuntimeError, match="exceed a block"):
        ms.maxsim(Q, D)


# ---- K9: dropout, bit-equal to the plain version's Philox stream ----

def _dropout_route(x, seed, thr, route):
    """Forward and backward of K9 on ``route``: "packed" through
    ``hw_dropout`` and autograd, "simple" through ``_launch`` on the input and
    on the gradient (the backward is the same kernel)."""
    from colbert_tpu_torch.ops import dropout as dr

    g = torch.randn(x.shape, device=x.device).to(x.dtype)
    before = dr.hw_dropout.launches.value, dr.route_launches[route].value
    if route == "simple":
        y, dx = dr._launch(x, seed, thr, route="simple"), dr._launch(g, seed, thr, route="simple")
    else:
        xg = x.detach().requires_grad_(True)  # x's storage, offset and strides
        y = dr.hw_dropout(xg, seed, thr)
        (dx,) = torch.autograd.grad(y, xg, g)
        y = y.detach()
    torch.cuda.synchronize()
    assert (dr.hw_dropout.launches.value, dr.route_launches[route].value) == (before[0] + 2, before[1] + 2)
    return y, dx, g


def _special(dtype, n, device):
    fi = torch.finfo(dtype)
    special = torch.tensor([fi.tiny / 2, -fi.tiny / 3, fi.tiny / 64, fi.tiny, -fi.tiny, 0.0, -0.0, float("inf"),
                            -float("inf"), float("nan"), fi.max, -fi.max], dtype=torch.float64)
    x = torch.from_numpy(np.random.default_rng(n).normal(size=n))
    x[::5] = special.repeat(-(-x[::5].numel() // special.numel()))[: x[::5].numel()]
    return x.to(dtype).to(device)


_SEED = 0x1234_5678_9ABC_DEF0
_K9_CASES = [  # shape, dtype, seed, thr, special values (subnormals, +-0, +-inf, NaN, +-max) at every 5th element
    ((4, 12, 384, 384), torch.bfloat16, _SEED, 26, False),
    ((68, 12, 384, 384), torch.bfloat16, _SEED, 26, False),  # the retriever's attention probabilities (34 x 2)
    ((20, 16, 384, 384), torch.bfloat16, _SEED, 26, False),  # the cross-encoder's attention probabilities (4 x 5)
    ((20, 384, 1024), torch.bfloat16, _SEED, 26, False),     # the cross-encoder's hidden states
    ((20, 384, 1024), torch.float32, _SEED, 26, False),
    ((20, 384, 1024), torch.float16, _SEED, 26, False),
    ((1001, 3), torch.float32, _SEED, 26, False),   # odd element count: the scalar tail
    ((7, 33), torch.float16, _SEED, 26, False),
    ((33,), torch.float16, _SEED, 26, False),
    ((5, 4099), torch.bfloat16, 0, 51, False),      # the seed's edges
    ((5, 4099), torch.bfloat16, 1 << 62, 51, False),
    ((5, 4099), torch.bfloat16, (1 << 64) - 1, 51, False),
] + [((40_003,), dtype, 91 + thr, thr, True)       # HMUL2 and FMUL round to nearest and keep subnormals
     for dtype in (torch.bfloat16, torch.float16, torch.float32) for thr in (1, 26, 128, 200, 255)]


@pytest.mark.parametrize("route", ["packed", "simple"])
@pytest.mark.parametrize("shape,dtype,seed,thr,special", _K9_CASES)
def test_dropout_kernel_bit_equal(cuda_device, route, shape, dtype, seed, thr, special):
    """Both routes, forward and backward, bit-equal to the plain version (NaN
    by position), dropping exactly where the mask says, and equal to each other."""
    from colbert_tpu_torch.ops import dropout as dr

    x = (_special(dtype, shape[0], cuda_device) if special else torch.randn(shape, device=cuda_device).to(dtype))
    y, dx, g = _dropout_route(x, seed, thr, route)
    assert dr.same_bits(y, dr.hw_dropout_ref(x, seed, thr))
    assert dr.same_bits(dx, dr.hw_dropout_ref(g, seed, thr))
    keep = dr.mask_bytes(x.numel(), seed, cuda_device).view(shape) >= thr
    assert torch.equal(y == 0, ~keep | (x == 0))
    if route == "simple":
        assert dr.same_bits(y, dr.hw_dropout(x, seed, thr))


@pytest.mark.parametrize("num_layers", [3, 24])  # 24: the cross-encoder's depth (macbert-large), at narrow widths
def test_dropout_launches_per_ce_step(cuda_device, tmp_path, num_layers):
    """A cross-encoder train step launches K9 at every dropout site, forward
    and backward: 2 x (1 + 3 x layers), 146 at 24 layers, all on route
    "packed", and never falls back to the plain version."""
    from colbert_tpu_torch.config import CETrainConfig, ColbertConfig, ModelConfig, TokenizerConfig
    from colbert_tpu_torch.ops import dropout as dr
    from colbert_tpu_torch.tokenization import ColbertTokenizer, build_vocab, write_vocab
    from colbert_tpu_torch.training import CETrainer

    words = ["apple", "river", "piano", "ocean", "forest"]
    vp = write_vocab(build_vocab([" ".join(words)]), tmp_path / "vocab.txt")
    cfg = ColbertConfig(
        ce_model=ModelConfig(vocab_size=128, hidden_size=64, num_layers=num_layers, num_heads=4,
                             intermediate_size=128, max_position_embeddings=64, dtype="bfloat16"),
        tokenizer=TokenizerConfig(vocab_path=vp, ce_maxlen=32),
        ce_train=CETrainConfig(per_device_batch_size=2, neg_num=2, neg_pool_lo=0, neg_pool_hi=4,
                               checkpoint_dir=str(tmp_path / "ce")),
    )
    exs = [{"question": w, "positive_ctxs": [w + " " + w], "hard_negative_ctxs": [o for o in words if o != w]}
           for w in words[:2]]
    t = CETrainer(cfg, ColbertTokenizer(cfg.tokenizer, cfg.multiview), device=cuda_device)
    t._init_state(2)
    ids, attn, group, teacher = t._build_pairs(exs, "train")
    counters = dr.hw_dropout.launches, dr.route_launches["packed"], dr.route_launches["simple"]
    before = [c.value for c in counters]
    loss = t.train_step(ids, attn, group, teacher, 0)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    n = 2 * (1 + 3 * num_layers)
    assert [c.value - b for c, b in zip(counters, before)] == [n, n, 0]
    assert num_layers != 24 or n == 146


@pytest.mark.parametrize("route", ["packed", "simple"])
def test_dropout_kernel_unaligned_view(cuda_device, route):
    """A view that starts off 16-byte alignment takes the scalar path, and a
    non-contiguous input is copied first; both still equal the plain version,
    forward and backward."""
    from colbert_tpu_torch.ops import dropout as dr

    for flat, off in ((torch.randn(4097, device=cuda_device, dtype=torch.bfloat16), 1),
                      (torch.randn(40_961, device=cuda_device, dtype=torch.bfloat16), 3)):
        view = flat[off:]
        assert view.data_ptr() % 16
        y, dx, g = _dropout_route(view, 99, 51, route)
        assert dr.same_bits(y, dr.hw_dropout_ref(view, 99, 51)) and dr.same_bits(dx, dr.hw_dropout_ref(g, 99, 51))
    strided = torch.randn(64, 513, device=cuda_device, dtype=torch.float16).t()
    assert not strided.is_contiguous()
    y, dx, g = _dropout_route(strided, 7, 26, route)
    assert dr.same_bits(y, dr.hw_dropout_ref(strided.contiguous(), 7, 26))
    assert dr.same_bits(dx, dr.hw_dropout_ref(g, 7, 26))


# ---- K4/K5: fused gather + MaxSim rerank, limit 1e-4 (only the summation order differs) ----

def _rerank_inputs(device, seed, num_docs, dv, dim, B, qv, cand):
    """bf16 and int8 tables over one set of unit rows, queries (the first
    with masked views) and their descaled copy for int8, on the card."""
    from colbert_tpu_torch.ops import rerank as rr

    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(num_docs * dv, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    Qm = rng.normal(size=(B, qv, dim)).astype(np.float32)
    Qm /= np.linalg.norm(Qm, axis=-1, keepdims=True)
    Qm[0, qv // 2 :] = 0.0
    q8, scale = rr.quantize_emb_table(emb)
    Q = torch.from_numpy(Qm).to(device)
    return (torch.from_numpy(cand).to(device), Q, torch.from_numpy(emb).to(device).to(torch.bfloat16),
            torch.from_numpy(q8).to(device), Q * torch.from_numpy(1.0 / scale).to(device))


def _assert_rerank_kernels_match_plain(cand, Q, table, t8, Qs, dv):
    """K4 and K5 against their plain versions, each launched once on the
    route :func:`rerank_plan` names and no other."""
    from colbert_tpu_torch.ops import rerank as rr

    route = rr.rerank_plan(dv, Q.shape[1], Q.shape[2])
    before = {k: c.value for k, c in rr.route_launches.items()}
    k4, k5 = rr.maxsim_rerank_uniform.launches.value, rr.maxsim_rerank_uniform_int8.launches.value
    got = rr.maxsim_rerank_uniform(cand, Q, table, dv=dv)
    got8 = rr.maxsim_rerank_uniform_int8(cand, Qs, t8, dv=dv)
    torch.cuda.synchronize()
    assert (rr.maxsim_rerank_uniform.launches.value, rr.maxsim_rerank_uniform_int8.launches.value) == (k4 + 1, k5 + 1)
    assert {k: c.value - before[k] for k, c in rr.route_launches.items()} == {k: 2 * (k == route) for k in before}
    for g, want in ((got, rr.maxsim_rerank_uniform_ref(cand, Q, table, dv=dv)),
                    (got8, rr.maxsim_rerank_uniform_int8_ref(cand, Qs, t8, dv=dv))):
        assert g.shape == cand.shape and g.dtype == torch.float32
        assert torch.equal(torch.isfinite(g), cand >= 0) and torch.isneginf(g[cand < 0]).all()
        torch.testing.assert_close(g, want, rtol=0, atol=1e-4)
    return route


@pytest.mark.parametrize("num_docs,dv,dim,B,qv,C,route", [
    (3000, 16, 768, 144, 16, 4096, "wgmma"),  # the serving point's shapes, fewer docs
    (700, 16, 128, 9, 16, 300, "wgmma"),      # two 64-dim stages
    (500, 37, 128, 5, 32, 130, "staged"),     # three 16-row doc tiles, two 16-row query tiles
    (90, 5, 32, 3, 3, 77, "staged"),          # short everything, C not a multiple of the block's 64
    (400, 16, 80, 6, 16, 50, "staged"),       # dim not whole 64-dim stages
])
def test_rerank_kernels_match_plain(cuda_device, num_docs, dv, dim, B, qv, C, route):
    rng = np.random.default_rng(num_docs + C)
    cand = rng.integers(0, num_docs, size=(B, C)).astype(np.int32)
    cand[rng.random((B, C)) < 0.2] = -1
    args = _rerank_inputs(cuda_device, num_docs + C, num_docs, dv, dim, B, qv, cand)
    assert _assert_rerank_kernels_match_plain(*args, dv) == route


@pytest.mark.parametrize("kind", EDGES)
def test_rerank_schedule_edges_on_the_card(cuda_device, kind):
    """The "wgmma" route at the serving shape (16 rows, 16 views, 768 dims)
    on the schedule's edges: duplicate pids in a row, a row of -1s, one doc
    named by every query, every pair a distinct doc, C = 77, empty windows."""
    B, C = 24, (77 if kind == "C = 77" else 300)
    num_docs = B * C + 5 if kind == "all distinct" else 2500
    cand = edge_cand(kind, np.random.default_rng(EDGES.index(kind)), num_docs, B, C)
    args = _rerank_inputs(cuda_device, EDGES.index(kind), num_docs, 16, 768, B, 16, cand)
    assert _assert_rerank_kernels_match_plain(*args, 16) == "wgmma"


def test_rerank_never_synchronises(cuda_device):
    """K4 and K5 on route "wgmma", schedule included, with torch's sync debug
    mode raising on any host synchronisation."""
    from colbert_tpu_torch.ops import rerank as rr

    rng = np.random.default_rng(7)
    cand = rng.integers(-1, 2000, size=(32, 512)).astype(np.int32)
    cand, Q, table, t8, Qs = _rerank_inputs(cuda_device, 7, 2000, 16, 768, 32, 16, cand)
    rr.maxsim_rerank_uniform(cand, Q, table, dv=16)  # the library is built and loaded outside the check
    torch.cuda.synchronize()
    before = rr.route_launches["wgmma"].value
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = rr.maxsim_rerank_uniform(cand, Q, table, dv=16)
        got8 = rr.maxsim_rerank_uniform_int8(cand, Qs, t8, dv=16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert rr.route_launches["wgmma"].value == before + 2
    torch.testing.assert_close(got, rr.maxsim_rerank_uniform_ref(cand, Q, table, dv=16), rtol=0, atol=1e-4)
    torch.testing.assert_close(got8, rr.maxsim_rerank_uniform_int8_ref(cand, Qs, t8, dv=16), rtol=0, atol=1e-4)


# ---- K6/K7: sq list scans; scores within 1e-5, rows equal except at near ties ----

def _assert_ranked(s_want, r_want, s_got, r_got, tol=1e-5, got_at_want=None):
    """Scores within ``tol``; rows equal except at near ties."""
    from colbert_tpu_torch.ops.sq_probe_batched import ranked_mismatch

    err, bad = ranked_mismatch(s_want, r_want, s_got, r_got, tol, got_at_want)
    assert err <= tol and bad == 0, (err, bad)


def _assert_ranked_beyond_ties(want, got, codes, q):
    """``got`` (n, r) scores and rows against the plain version's top-(r+1)
    ``want`` (a kernel's r-th row may be its (r+1)-th where the two tie):
    scores within 1e-5, rows equal except at near ties.  The tensor cores
    sum in another order than the plain version, so two different rows may
    round to one fp32 score on one side only: an exact tie of ``want``
    counts as a near tie where the two rows' exact sums (fp64, against
    ``q`` (n, D), each row's query) differ."""
    (ws, wr), (gs, gr) = want, got
    r = gs.shape[1]
    fin = torch.isfinite(ws)
    same = (ws[:, 1:] == ws[:, :-1]) & fin[:, 1:]
    tie = torch.zeros_like(fin)
    tie[:, 1:] |= same
    tie[:, :-1] |= same
    exact = ws.double()
    i, k = torch.nonzero(tie, as_tuple=True)
    exact[i, k] = (codes[wr[i, k].long()].double() * q[i].double()).sum(dim=1)
    _assert_ranked(ws, wr, torch.cat([gs, ws[:, r:]], 1), torch.cat([gr, wr[:, r:]], 1), got_at_want=exact)


def _sq_case(device, seed, K, D, max_len, T):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, size=K)
    lens[0] = 0
    offsets = np.zeros(K + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    codes = rng.integers(-127, 128, size=(int(offsets[-1]), D)).astype(np.int8)
    b = offsets[1]
    if lens[1] > 140:
        codes[b + 5] = codes[b + 140]  # an exact tie across blocks
    qs = (rng.normal(size=(T, D)) / (127.0 * np.sqrt(D))).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)
    return to(codes), to(offsets), to(qs)


@pytest.mark.parametrize("K,D,max_len,T,nprobe,tpl,r", [
    (4096, 64, 160, 2304, 128, 128, 8),  # the serving point's slot schedule
    (64, 16, 700, 300, 8, 32, 2),
    (33, 128, 300, 90, 5, 7, 16),
])
def test_slot_scan_kernel_matches_plain(cuda_device, K, D, max_len, T, nprobe, tpl, r):
    from colbert_tpu_torch.ops import sq_probe_batched as sp

    codes, offsets, qs = _sq_case(cuda_device, K + D, K, D, max_len, T)
    coarse = torch.randn(T, K, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(K))
    vals, lists = torch.topk(coarse, nprobe, dim=1)
    sched, _ = sp.build_slot_schedule_dense(coarse >= vals[:, -1:], lists, tpl=tpl, groups=8)
    filled = sched.qidx[:, 0] >= 0  # the kernel leaves empty slots unwritten
    assert int(filled.sum()) > 0
    _assert_slot_scan_matches_plain(sched.qidx, offsets, qs, codes, r)


def _slot_rows(t, filled):
    """(S, r, tpl) -> the filled slots' (positions, r) rows."""
    return t[filled].transpose(1, 2).reshape(-1, t.shape[1])


def _assert_slot_scan_matches_plain(qidx, offsets, qs, codes, r):
    """K6 through its wrapper (route "mma", one launch counted on it), then
    on route "staged" on the same input: both against the plain version at
    the filled slots, and against each other."""
    from colbert_tpu_torch.ops import sq_probe_batched as sp

    assert sp.scan_plan(qs.shape[1], qidx.shape[1], r) == "mma"
    before = {k: c.value for k, c in sp.route_launches.items()}
    n = sp.sq_batch_list_scan.launches.value
    gs, gr = sp.sq_batch_list_scan(qidx, offsets, qs, codes, r=r)
    ss, sr = sp._launch(qidx, offsets, qs, codes, r, hot=False, route="staged")
    torch.cuda.synchronize()
    assert sp.sq_batch_list_scan.launches.value == n + 1
    assert {k: c.value - before[k] for k, c in sp.route_launches.items()} == {"mma": 1, "staged": 1}
    ws, wr = sp.sq_batch_list_scan_ref(qidx, offsets, qs, codes, r=r)
    f = qidx[:, 0] >= 0
    _assert_ranked(_slot_rows(ws, f), _slot_rows(wr, f), _slot_rows(gs, f), _slot_rows(gr, f))
    _assert_ranked(_slot_rows(ws, f), _slot_rows(wr, f), _slot_rows(ss, f), _slot_rows(sr, f))
    _assert_ranked(_slot_rows(ss, f), _slot_rows(sr, f), _slot_rows(gs, f), _slot_rows(gr, f))
    return gs, gr


@pytest.mark.parametrize("D,tpl,r", [(16, 1, 1), (16, 7, 16), (32, 7, 1), (32, 1, 16), (128, 7, 16), (128, 1, 1)])
def test_slot_scan_mma_route_shapes(cuda_device, D, tpl, r):
    """Route "mma" at every sq_dim but the serving one, one token a slot and
    a member count that is not a multiple of the 8-token n-tile, r at 1 and 16."""
    from colbert_tpu_torch.ops import sq_probe_batched as sp

    K, T, nprobe = 40, 60, 6
    codes, offsets, qs = _sq_case(cuda_device, D * 10 + tpl + r, K, D, 400, T)
    coarse = torch.randn(T, K, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(D + r))
    vals, lists = torch.topk(coarse, nprobe, dim=1)
    sched, _ = sp.build_slot_schedule_dense(coarse >= vals[:, -1:], lists, tpl=tpl, groups=8)
    assert int((sched.qidx[:, 0] >= 0).sum()) > 0
    _assert_slot_scan_matches_plain(sched.qidx, offsets, qs, codes, r)


@pytest.mark.parametrize("kind", ["empty_list", "long_list_ties", "nothing_filled"])
def test_slot_scan_work_list_edges(cuda_device, kind):
    """A filled slot on an empty list (-inf / -1 for its members); one list
    of 3,000 rows at an unaligned offset whose rows tie exactly within and
    across 128-row blocks (codes in -1..1, queries on a 1/64 grid: every sum
    exact on both sides); a schedule with no filled slot (nothing written)."""
    from colbert_tpu_torch.ops import sq_probe_batched as sp

    rng = np.random.default_rng(len(kind))
    K, D, tpl, r, T = 8, 16, 16, 8, 40
    lens = np.array([37, 3000, 0, 150, 0, 64, 1, 200])
    offsets = np.zeros(K + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    codes = rng.integers(-1, 2, size=(int(offsets[-1]), D)).astype(np.int8)
    b = offsets[1]
    codes[b + 300] = codes[b + 5]                    # across blocks
    codes[b + 2000] = codes[b + 5]
    codes[b + 9] = codes[b + 3]                      # within a block
    qs = (rng.integers(-8, 9, size=(T, D)) / 64.0).astype(np.float32)
    qidx = np.full((2 * K, tpl), -1, np.int32)
    if kind != "nothing_filled":
        for s, m in ((1, 16), (2, 7), (3, 5), (K + 1, 9), (4, 1), (7, 3)):
            qidx[s, :m] = rng.choice(T, size=m, replace=False)
    to = lambda a: torch.from_numpy(a).to(cuda_device)
    qidx, offsets, codes, qs = to(qidx), to(offsets), to(codes), to(qs)
    items, count = sp.work_list_kernel(qidx, offsets)
    want_items, want_count = sp.slot_work_list(qidx, offsets)
    filled = qidx[:, 0] >= 0
    n = int(count)
    assert n == int(want_count) == int(filled.sum())
    got = items[:n].long()
    assert torch.equal(torch.sort(got)[0], torch.sort(want_items[:n].long())[0])  # the plain version's slots
    stages = ((torch.diff(offsets).long()[got % K] + 63) // 64).clamp(max=sp.WORK_BUCKETS - 1)
    assert (stages[1:] <= stages[:-1]).all()  # most stages first
    if kind == "nothing_filled":
        before = sp.route_launches["mma"].value
        sp.sq_batch_list_scan(qidx, offsets, qs, codes, r=r)
        torch.cuda.synchronize()
        assert sp.route_launches["mma"].value == before + 1
        return
    gs, gr = _assert_slot_scan_matches_plain(qidx, offsets, qs, codes, r)
    if kind == "empty_list":  # slots 2 and 4 scan lists 2 and 4, which hold no rows
        for s, m in ((2, 7), (4, 1)):
            assert torch.isinf(gs[s, :, :m]).all() and (gs[s, :, :m] < 0).all() and (gr[s, :, :m] == -1).all()
    else:  # the long list's top-r holds tied rows from several blocks
        top = gr[1].flatten()
        assert ((top >= b) & (top < b + 3000)).all()


def test_slot_scan_never_synchronises(cuda_device):
    """The whole sq-batched probe (plan, work list, K6 on route "mma", K7,
    postprocess) with torch's sync debug mode raising on any host
    synchronisation; then against the same probe built from the plain
    versions on the same plan."""
    from colbert_tpu_torch.ops import ivf, sq_probe_batched as sp

    K, D, T, d = 256, 64, 512, 32
    codes, offsets, _ = _sq_case(cuda_device, 11, K, D, 200, T)
    g = torch.Generator(cuda_device).manual_seed(11)
    q = torch.randn(T, d, device=cuda_device, generator=g)
    cent = torch.randn(K, d, device=cuda_device, generator=g)
    proj = torch.randn(d, D, device=cuda_device, generator=g) / d ** 0.5
    scales = torch.full((D,), 127.0 * 8, device=cuda_device)  # scores ~ 1
    args = (q, cent, proj, scales, codes, offsets)
    kw = dict(nprobe=16, depth=32, r=4, hot_cap=8, tpl=16, groups=1)  # lists over 16 members go to K7
    ivf.ivf_probe_sq_batched(*args, **kw)  # the library is built and loaded outside the check
    torch.cuda.synchronize()
    before = sp.route_launches["mma"].value, sp.hot_route_launches["mma"].value
    torch.cuda.set_sync_debug_mode("error")
    try:
        s, rows = ivf.ivf_probe_sq_batched(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (sp.route_launches["mma"].value, sp.hot_route_launches["mma"].value) == (before[0] + 1, before[1] + 1)
    plan = ivf.sq_probe_plan(q, cent, proj, scales, nprobe=16, hot_cap=8, tpl=16, groups=1)
    assert int((plan.hot_ids >= 0).sum()) > 0
    out = sp.sq_batch_list_scan_ref(plan.sched.qidx, offsets, plan.qs, codes, r=4)
    hot = (plan.hot_pos, *sp.sq_hot_list_scan_ref(plan.hot_ids, offsets, plan.qs, codes, r=4))
    ws, wr = sp.probe_batched_postprocess(plan.sched, *out, plan.lists, 32, plan.pair_valid, hot=hot)
    assert torch.isfinite(ws).sum() > T * 16
    _assert_ranked(ws, wr, s, rows)


def _hot_members(device, seed, T, H, p):
    """(T, H) bool: each token probes each hot entry with probability p;
    entry 1 is probed by every token, entry 2 by none."""
    m = torch.from_numpy(np.random.default_rng(seed).random((T, H)) < p)
    m[:, 1], m[:, 2] = True, False
    return m.to(device)


def _assert_hot_scan_matches_plain(hot, offsets, qs, codes, r, members):
    """K7 through its wrapper (route "mma", one launch counted on it), then
    on route "staged" (every token) on the same input: both against the
    plain version at the entries a probe reads (real hot lists; member
    tokens when ``members`` is given); for route "mma", whose tensor cores
    sum in another order, an exact tie of the plain version is excused
    where the rows' exact sums differ."""
    from colbert_tpu_torch.ops import sq_probe_batched as sp

    before = {k: c.value for k, c in sp.hot_route_launches.items()}
    n = sp.sq_hot_list_scan.launches.value
    gs, gr = sp.sq_hot_list_scan(hot, offsets, qs, codes, r=r, members=members)
    ss, sr = sp._launch(hot, offsets, qs, codes, r, hot=True, route="staged", members=members)
    torch.cuda.synchronize()
    assert sp.sq_hot_list_scan.launches.value == n + 1
    assert {k: c.value - before[k] for k, c in sp.hot_route_launches.items()} == {"mma": 1, "staged": 1}
    ws, wr = sp.sq_hot_list_scan_ref(hot, offsets, qs, codes, r=r + 1, members=members)
    T = qs.shape[0]
    read = (hot >= 0)[:, None].expand(-1, T)
    if members is not None:
        read = read & members.T
    rows = lambda t: t.transpose(1, 2)[read]  # (read entries, r)
    q = qs[torch.arange(T, device=qs.device).expand(hot.shape[0], T)[read]]
    _assert_ranked_beyond_ties((rows(ws), rows(wr)), (rows(gs), rows(gr)), codes, q)
    _assert_ranked(rows(ws)[:, :r], rows(wr)[:, :r], rows(ss), rows(sr))
    return gs, gr, read


@pytest.mark.parametrize("members", [None, 0.15])
@pytest.mark.parametrize("K,D,max_len,T,H,r", [
    (200, 64, 1500, 2304, 128, 8),  # the serving point's hot scan: 128 lists x 2,304 tokens
    (20, 32, 400, 130, 7, 3),
    (12, 128, 300, 300, 5, 16),
    (12, 16, 300, 257, 6, 1),
])
def test_hot_scan_kernel_matches_plain(cuda_device, K, D, max_len, T, H, r, members):
    """K7 on both routes, over every token and over member tokens (entry 1
    probed by every token, entry 2 by none); one entry is -1 and one scans
    the empty list 0."""
    codes, offsets, qs = _sq_case(cuda_device, K * 3 + D, K, D, max_len, T)
    hot = torch.arange(1, H + 1, dtype=torch.int32, device=cuda_device) % K
    hot[-1] = -1
    hot[3 % (H - 1)] = 0
    m = None if members is None else _hot_members(cuda_device, T + H, T, H, members)
    gs, gr, read = _assert_hot_scan_matches_plain(hot, offsets, qs, codes, r, m)
    empty = read & (hot == 0)[:, None]  # list 0 holds no rows
    assert torch.isinf(gs.transpose(1, 2)[empty]).all() and (gr.transpose(1, 2)[empty] == -1).all()
    assert torch.isfinite(gs.transpose(1, 2)[read]).any()


@pytest.mark.parametrize("kind", ["no_hot_list", "every_token", "members"])
def test_hot_schedule_kernel_matches_plain(cuda_device, kind):
    """K7's slots and work list on route "mma" from its kernels: the slots
    of real hot entries equal the plain layout (member tokens ascending,
    128 a slot, -1 past the last), the work list the plain version's filled
    slots (order within a bucket follows atomics), most stages first.  With
    no hot list (the served plan at nprobe 128) nothing is filled, and the
    scan writes nothing."""
    from colbert_tpu_torch.ops import sq_probe_batched as sp

    K, D, T, H = 300, 64, 2304, 128
    codes, offsets, qs = _sq_case(cuda_device, 5, K, D, 700, T)
    hot = torch.arange(H, dtype=torch.int32, device=cuda_device) * 2 + 1
    hot[::7] = -1
    if kind == "no_hot_list":
        hot[:] = -1
    m = _hot_members(cuda_device, 9, T, H, 0.1) if kind == "members" else None
    qidx, items, count = sp.hot_schedule_kernel(hot, offsets, T, m)
    want = sp.hot_member_schedule(hot, T, m)
    want_items, want_count = sp.slot_work_list(want, offsets, lmap=hot)
    real = (hot >= 0).repeat(qidx.shape[0] // H)
    assert torch.equal(qidx[real], want[real])
    n = int(count)
    assert n == int(want_count) == (0 if kind == "no_hot_list" else n) and (n > 0) == (kind != "no_hot_list")
    got = items[:n].long()
    assert torch.equal(torch.sort(got)[0], torch.sort(want_items[:n].long())[0])
    stages = ((torch.diff(offsets).long()[hot.long()[got % H]] + 63) // 64).clamp(max=sp.WORK_BUCKETS - 1)
    assert (stages[1:] <= stages[:-1]).all()
    if kind == "no_hot_list":
        before = sp.hot_route_launches["mma"].value
        sp.sq_hot_list_scan(hot, offsets, qs, codes, r=8)
        torch.cuda.synchronize()
        assert sp.hot_route_launches["mma"].value == before + 1
    else:
        _assert_hot_scan_matches_plain(hot, offsets, qs, codes, 8, m)


# ---- K8: pq4 list scan; K10: sq window scan (scores within 1e-5, rows equal except at near ties) ----

def _pq4_case(device, seed, K, m, max_len, T, nprobe, every=False):
    """Packed pq4 codes with an empty list, a list of 300 rows (more than
    two 128-row blocks, and three 128-row passes of route "onehot") drawn from five
    distinct rows (exact ties), and a random LUT.  Every token probes list 0
    or 1 first, or with ``every`` list 1."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, size=K)
    lens[0], lens[1] = 0, 300
    offsets = np.zeros(K + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    codes = rng.integers(-128, 128, size=(int(offsets[-1]), m // 2)).astype(np.int8)
    pool = codes[offsets[1] : offsets[1] + 5].copy()
    codes[offsets[1] : offsets[2]] = pool[rng.integers(0, 5, size=300)]
    first = np.ones(T, np.int64) if every else rng.integers(0, 2, size=T)
    lists = np.array([[f] + [l for l in rng.permutation(K) if l != f][: nprobe - 1] for f in first], np.int32)
    lut = rng.normal(scale=0.05, size=(T, m, 16)).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)
    return to(lists), to(offsets), to(lut), to(codes)


def _assert_pq4_routes_match_plain(lists, offsets, lut, codes, r):
    """K8 through its wrapper (route "onehot", one launch counted on it),
    then on route "lookup" on the same input: both against the plain
    version, and against each other."""
    from colbert_tpu_torch.ops import pq4

    assert pq4.pq4_scan_plan(lut.shape[1], r) == "onehot"
    before = {k: c.value for k, c in pq4.route_launches.items()}
    n = pq4.pq4_list_scan.launches.value
    gs, gr = pq4.pq4_list_scan(lists, offsets, lut, codes, r=r)
    ls, lr = pq4._launch(lists, offsets, lut, codes, r, route="lookup")
    torch.cuda.synchronize()
    assert pq4.pq4_list_scan.launches.value == n + 1
    assert {k: c.value - before[k] for k, c in pq4.route_launches.items()} == {"onehot": 1, "lookup": 1}
    ws, wr = pq4.pq4_list_scan_ref(lists, offsets, lut, codes, r=r)
    flat = lambda t: t.reshape(-1, r)
    _assert_ranked(flat(ws), flat(wr), flat(gs), flat(gr))
    _assert_ranked(flat(ws), flat(wr), flat(ls), flat(lr))
    _assert_ranked(flat(ls), flat(lr), flat(gs), flat(gr))
    return gs, gr


@pytest.mark.parametrize("K,m,max_len,T,nprobe,r", [
    (4096, 128, 160, 2304, 128, 8),  # the serving point: 2,304 tokens x 128 lists, m 128, r 8
    (40, 16, 400, 70, 6, 2),
    (17, 256, 300, 33, 5, 16),
])
def test_pq4_scan_kernel_matches_plain(cuda_device, K, m, max_len, T, nprobe, r):
    lists, offsets, lut, codes = _pq4_case(cuda_device, K + m, K, m, max_len, T, nprobe)
    gs, gr = _assert_pq4_routes_match_plain(lists, offsets, lut, codes, r)
    empty = lists == 0  # the empty list yields -inf / -1 only
    assert torch.isinf(gs[empty]).all() and (gr[empty] == -1).all()


@pytest.mark.parametrize("m,r", [(8, 1), (32, 16), (64, 3), (128, 8)])
def test_pq4_onehot_list_probed_by_every_token(cuda_device, m, r):
    """The tied 300-row list probed by all 2,304 tokens (36 items of 64
    members, three 128-row passes each), beside short lists and the empty
    one, at code widths of 4 to 64 bytes, r 1..16."""
    lists, offsets, lut, codes = _pq4_case(cuda_device, m + r, 300, m, 90, 2304, 8, every=True)
    gs, gr = _assert_pq4_routes_match_plain(lists, offsets, lut, codes, r)
    top = gr[:, 0]  # list 1, probed first: its rows only
    assert ((top >= offsets[1]) & (top < offsets[2])).all()


def test_pq4_work_list_kernel_matches_plain(cuda_device):
    """Route "onehot"'s work list from its kernels against the plain version
    at the serving shape with one list probed by every token: per list the
    same pairs and items, the same count, most work first; list ranges,
    pair order within a list and item order within a bucket follow atomics."""
    from colbert_tpu_torch.ops import pq4

    lists, offsets, _, _ = _pq4_case(cuda_device, 5, 4096, 128, 160, 2304, 128, every=True)
    got, want = pq4.work_list_kernel(lists, offsets), pq4.pq4_work_list(lists, offsets)
    n = int(want.count)
    assert int(got.count) == n and torch.equal(got.cnt, want.cnt)
    l_flat = lists.reshape(-1).long()
    pos = torch.arange(l_flat.numel(), device=cuda_device)
    for wl in (got, want):  # every pair once, each in its list's range
        assert torch.equal(torch.sort(wl.pairs.long())[0], pos)
        at = l_flat[wl.pairs.long()]
        assert ((pos >= wl.lstart.long()[at]) & (pos < wl.lstart.long()[at] + wl.cnt.long()[at])).all()

    def item_sets(wl):
        items = wl.items[:n].long()
        l = l_flat[wl.pairs.long()[items]]
        members = torch.clamp(wl.cnt.long()[l] + wl.lstart.long()[l] - items, max=pq4.ONEHOT_GROUP)
        return l, members, pq4.item_buckets(offsets, l, members)
    gl, gm, gb = item_sets(got)
    wl_, wm, wb = item_sets(want)
    assert (gb[1:] <= gb[:-1]).all() and torch.equal(gb, wb)
    key = lambda l, m: torch.sort(l * 1000 + m)[0]
    assert torch.equal(key(gl, gm), key(wl_, wm))  # the same items: each list's count of each size


def test_pq4_probe_never_synchronises(cuda_device):
    """The whole pq4 probe (coarse lists, LUT, K8 on route "onehot" with its
    work list, top-depth) with torch's sync debug mode raising on any host
    synchronisation; then against the same probe on the plain K8."""
    from colbert_tpu_torch.ops import pq4

    g = torch.Generator(cuda_device).manual_seed(3)
    K, d, m, T = 256, 64, 32, 512
    lens = torch.randint(0, 200, (K,), device=cuda_device, generator=g)
    offsets = torch.zeros(K + 1, dtype=torch.int32, device=cuda_device)
    offsets[1:] = torch.cumsum(lens, 0)
    n_rows = int(offsets[-1])
    codes = torch.randint(-128, 128, (n_rows, m // 2), device=cuda_device, generator=g).to(torch.int8)
    q = torch.randn(T, d, device=cuda_device, generator=g)
    cent = torch.randn(K, d, device=cuda_device, generator=g)
    cb = torch.randn(m, 16, d // m, device=cuda_device, generator=g) / d ** 0.5
    kw = dict(nprobe=16, depth=32, r=4)
    pq4.ivf_probe_pq4(q, cent, cb, codes, offsets, **kw)  # the library is built and loaded outside the check
    torch.cuda.synchronize()
    before = pq4.route_launches["onehot"].value
    torch.cuda.set_sync_debug_mode("error")
    try:
        s, rows = pq4.ivf_probe_pq4(q, cent, cb, codes, offsets, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pq4.route_launches["onehot"].value == before + 1
    from colbert_tpu_torch.ops.ivf import coarse_lists, topk_first
    from colbert_tpu_torch.ops.pq import adc_lut

    ws, wr = pq4.pq4_list_scan_ref(coarse_lists(q, cent, 16).int(), offsets, adc_lut(q, cb), codes, r=4)
    ws, i = topk_first(ws.view(T, -1), 32)
    wr = torch.where(torch.isfinite(ws), wr.view(T, -1).gather(1, i), -1).int()
    assert torch.isfinite(ws).sum() > T * 16
    _assert_ranked(ws, wr, s, rows)


@pytest.mark.parametrize("D,N,T,nprobe,cap", [
    (64, 320_000, 2304, 128, 463),  # the serving point's windows
    (16, 5000, 50, 7, 300),
    (128, 3000, 9, 3, 129),
])
def test_sq_window_scan_kernel_matches_plain(cuda_device, D, N, T, nprobe, cap):
    from colbert_tpu_torch.ops import sq_probe

    rng = np.random.default_rng(D + T)
    codes = torch.from_numpy(rng.integers(-128, 128, size=(N, D)).astype(np.int8)).to(cuda_device)
    starts = rng.integers(0, N - cap, size=(T, nprobe)).astype(np.int32)
    lens = rng.integers(0, cap + 1, size=(T, nprobe)).astype(np.int32)
    lens[0, :2] = 0, cap + 5  # an empty window, and one clipped to cap
    qs = (rng.normal(size=(T, D)) / (127.0 * np.sqrt(D))).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (starts, lens, qs)]
    before = sq_probe.sq_list_scan.launches.value
    got = sq_probe.sq_list_scan(*args, codes, cap=cap)
    torch.cuda.synchronize()
    assert sq_probe.sq_list_scan.launches.value == before + 1
    want = sq_probe.sq_list_scan_ref(*args, codes, cap=cap)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert int(fin.sum()) == int(np.minimum(lens, cap).sum())
    torch.testing.assert_close(got[fin], want[fin], rtol=0, atol=1e-5)


# ---- K10 route "fused": each token's top-depth in one launch (bit-equal to route "staged") ----

def _token_case(device, seed, D, N, T, nprobe, cap):
    """Random windows over N code rows, with: an empty window and one
    clipped to cap (token 0); every window over rows [0, cap), which hold
    one code row, so all its scores are exact ties, within and across lists
    (token 1, with nprobe * cap real rows, past the shared-memory budget
    when nprobe * cap is); two windows over the same rows (token 2); fewer
    real rows than a depth of 4 (token 3); a zero query, every score +0.0
    (token 4)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-128, 128, size=(N, D)).astype(np.int8)
    codes[:cap] = codes[0]
    starts = rng.integers(0, N - cap, size=(T, nprobe)).astype(np.int32)
    lens = rng.integers(0, cap + 1, size=(T, nprobe)).astype(np.int32)
    lens[0, :2] = 0, cap + 5
    starts[1], lens[1] = 0, cap
    starts[2, 1], lens[2, :2] = starts[2, 0], cap
    lens[3] = 0
    lens[3, -1] = min(3, cap)
    qs = (rng.normal(size=(T, D)) / (127.0 * np.sqrt(D))).astype(np.float32)
    qs[4] = 0.0
    to = lambda a: torch.from_numpy(a).to(device)
    return to(starts), to(lens), to(qs), to(codes)


def _assert_token_routes(starts, lens, qs, codes, cap, depth, keys_cap=None):
    """Route "fused" (through ``sq_window_topk``, one K10 launch counted on
    it; or, with ``keys_cap``, launched alone) against route "staged" +
    ``_window_topk`` on the same input, bit for bit, and against the plain
    version's top-depth within near ties (scores within 1e-5; an exact tie
    of the plain version counts as near where the kernels' scores of the
    two rows differ, and two rows at one rank do where each scores within
    1e-5 of the other side's score there, on the other side)."""
    from colbert_tpu_torch.ops import sq_probe
    from colbert_tpu_torch.ops.sq_probe_batched import ranked_mismatch

    before = {k: c.value for k, c in sq_probe.route_launches.items()}
    n = sq_probe.sq_list_scan.launches.value
    if keys_cap is None:
        gs, gr = sq_probe.sq_window_topk(starts, lens, qs, codes, cap=cap, depth=depth)
    else:
        gs, gr = sq_probe._launch_fused(starts, lens, qs, codes, cap, depth, keys_cap)
    ss, sr = sq_probe.sq_window_topk(starts, lens, qs, codes, cap=cap, depth=depth, route="staged")
    torch.cuda.synchronize()
    fused = int(keys_cap is None)
    assert {k: c.value - before[k] for k, c in sq_probe.route_launches.items()} == {"fused": fused, "staged": 1}
    assert sq_probe.sq_list_scan.launches.value == n + fused + 1
    assert gs.shape == (starts.shape[0], depth) and gr.dtype == torch.int32
    assert torch.equal(gs.view(torch.int32), ss.view(torch.int32)) and torch.equal(gr, sr)
    dense = sq_probe.sq_list_scan(starts, lens, qs, codes, cap=cap)
    plain = sq_probe.sq_list_scan_ref(starts, lens, qs, codes, cap=cap)
    ws, wr = sq_probe._window_topk(plain, starts, cap, depth)
    _, wi = sq_probe.topk_first(plain, min(depth, plain.shape[1]))
    k = wi.shape[1]
    err, bad = ranked_mismatch(ws[:, :k], wr[:, :k], gs[:, :k], gr[:, :k], 1e-5, dense.gather(1, wi),
                               _plain_scores(qs, codes, gr[:, :k]))
    assert err <= 1e-5 and bad == 0, (err, bad)
    assert torch.isinf(gs[:, k:]).all() and (gr[:, k:] == -1).all()
    return gs, gr


def _plain_scores(qs, codes, rows):
    """fp32 scores of CSR ``rows`` (T, k) against each token's query, -inf at -1."""
    s = torch.einsum("tkd,td->tk", codes[rows.clamp(min=0).long()].float(), qs.float())
    return s.masked_fill(rows < 0, float("-inf"))


@pytest.mark.parametrize("D,N,T,nprobe,cap,depth", [
    (64, 320_000, 2304, 128, 463, 512),  # the serving point's windows
    (16, 5000, 50, 7, 300, 40),
    (32, 20_000, 40, 256, 400, 512),     # up to 102,400 rows a token: past the shared-memory budget
    (128, 3000, 9, 3, 129, 1000),        # depth past nprobe * cap
    (16, 8000, 40, 16, 300, 2048),       # the deepest top-depth route "fused" takes: four survivors a thread
])
def test_sq_window_topk_fused_matches_staged_and_plain(cuda_device, D, N, T, nprobe, cap, depth):
    from colbert_tpu_torch.ops import sq_probe

    assert sq_probe.sq_window_topk_plan(D, depth) == "fused"
    starts, lens, qs, codes = _token_case(cuda_device, D + T, D, N, T, nprobe, cap)
    gs, gr = _assert_token_routes(starts, lens, qs, codes, cap, depth)
    assert (gr[1, : min(depth, nprobe * cap)] >= 0).all() and (gr[1] < cap).all()  # all ties: rows of [0, cap)
    assert torch.isinf(gs[3, 3:]).all() and (gr[3, 3:] == -1).all() and (gr[3, :3] >= 0).all()
    assert (gs[4, : min(depth, int(lens[4].clamp(max=cap).sum()))].view(torch.int32) == 0).all()  # +0.0


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_sq_window_topk_fused_rescoring_path(cuda_device, D):
    """Route "fused" with no keys kept in shared memory (every pass scores
    the rows again) and with room for some tokens' keys only."""
    starts, lens, qs, codes = _token_case(cuda_device, D, D, 6000, 30, 9, 300)
    for keys_cap in (0, 1500):
        _assert_token_routes(starts, lens, qs, codes, 300, 64, keys_cap=keys_cap)


def test_token_probe_never_synchronises(cuda_device):
    """The whole token probe (coarse lists, sq_query, K10 on route "fused")
    with torch's sync debug mode raising on any host synchronisation; then
    against the same probe on route "staged"."""
    from colbert_tpu_torch.ops import ivf, sq_probe

    K, D, T, d = 256, 64, 512, 32
    codes, offsets, _ = _sq_case(cuda_device, 12, K, D, 200, T)
    g = torch.Generator(cuda_device).manual_seed(12)
    q = torch.randn(T, d, device=cuda_device, generator=g)
    cent = torch.randn(K, d, device=cuda_device, generator=g)
    proj = torch.randn(d, D, device=cuda_device, generator=g) / d ** 0.5
    scales = torch.full((D,), 127.0 * 8, device=cuda_device)
    cap = int(torch.diff(offsets).max())
    kw = dict(nprobe=16, cap=cap, depth=128)
    ivf.ivf_probe_sq(q, cent, proj, scales, codes, offsets, **kw)  # the library is built and loaded outside the check
    torch.cuda.synchronize()
    before = sq_probe.route_launches["fused"].value
    torch.cuda.set_sync_debug_mode("error")
    try:
        s, rows = ivf.ivf_probe_sq(q, cent, proj, scales, codes, offsets, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sq_probe.route_launches["fused"].value == before + 1
    lists = ivf.coarse_lists(q, cent, 16)
    starts = offsets[lists]
    lens = (offsets[lists + 1] - starts).clamp(max=cap)
    ws, wr = sq_probe.sq_window_topk(starts, lens, ivf.sq_query(q, proj, scales), codes, cap=cap, depth=128,
                                     route="staged")
    assert torch.isfinite(ws).sum() > T * 64
    assert torch.equal(s, ws) and torch.equal(rows, wr)


# ---- K11-K13: flash attention ----

# (B, nh, L, dtype, layout): the retriever's doc pass, the CE's pairs and the
# encode batch in the models' layout (heads-major views of (B, L, nh, hd));
# small contiguous cases at L 128 (the JAX kernel's single block) and 256, fp16;
# "unseen": the models' layout with query segment ids that no key has (those
# rows attend to no key: the JAX result, a mean over the masked keys)
@pytest.mark.parametrize("route", ["wgmma", "simple"])
@pytest.mark.parametrize("B,nh,L,dtype,layout", [
    (68, 12, 384, torch.bfloat16, "heads"),
    (20, 16, 384, torch.bfloat16, "heads"),
    (384, 12, 384, torch.bfloat16, "heads"),
    (3, 2, 128, torch.bfloat16, "contiguous"),
    (5, 4, 256, torch.float16, "contiguous"),
    (6, 4, 384, torch.bfloat16, "unseen"),
])
def test_flash_kernels_match_plain(cuda_device, B, nh, L, dtype, layout, route):
    """K11, K12 and K13 on ``route`` against the plain versions on the
    same inputs (the backward on the plain forward's l, m and di), within 2
    bf16 ulps of each element's head vector and at most 1e-3 of the elements
    past 2 ulps of their own magnitude; two runs bit-equal; on the route the
    wrapper takes, the autograd function equal to the launches (its backward
    on the rows kernel's di and 1 / l, which K12 and K13 both read)."""
    from colbert_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(cuda_device).manual_seed(B * L + nh)

    def t():
        if layout in ("heads", "unseen"):
            return torch.randn((B, L, nh, 64), generator=g, device=cuda_device).to(dtype).transpose(1, 2)
        return torch.randn((B, nh, L, 64), generator=g, device=cuda_device).to(dtype)
    q, k, v, do = t(), t(), t(), t()
    lengths = torch.randint(1, L + 1, (B,), generator=g, device=cuda_device)
    lengths[0] = L
    seg = (torch.arange(L, device=cuda_device)[None, :] < lengths[:, None]).to(torch.int32)
    q_seg, kv_seg = seg, seg
    if layout == "unseen":  # every third query of each row in segment 2, which no key has
        q_seg = torch.where(torch.arange(L, device=cuda_device)[None, :] % 3 == 1, 2, seg).to(torch.int32)
    args = (q, k, v, q_seg, kv_seg, 0.125)
    o, l, m = fa._launch_forward(*args, route=route)
    ro, rl, rm = fa.flash_forward_ref(*args)
    di = fa.flash_di(ro, do)
    bargs = (*args, rl, rm, do, di)
    dk, dv = fa._launch_dkv(*bargs, route=route)
    dq = fa._launch_dq(*bargs, route=route)
    want = fa.flash_backward_ref(*bargs)
    torch.cuda.synchronize()
    for what, got, ref in (("o", o, ro), ("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2])):
        head_ulps, share, _ = fa.close_in_head_ulps(got, ref)
        assert head_ulps <= 2 and share <= 1e-3, (what, head_ulps, share)
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)
    torch.testing.assert_close(m, rm, rtol=0, atol=1e-5)
    o2, l2, m2 = fa._launch_forward(*args, route=route)
    dk2, dv2 = fa._launch_dkv(*bargs, route=route)
    assert torch.equal(o, o2) and torch.equal(l, l2) and torch.equal(m, m2)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2) and torch.equal(dq, fa._launch_dq(*bargs, route=route))
    if route != "wgmma":  # the autograd function runs the default route
        return
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, q_seg, kv_seg, 0.125)
    out.backward(do)
    di_card, inv_l = fa._launch_rows(o, do, l)
    own = (q, k, v, q_seg, kv_seg, 0.125, l, m, do, di_card)
    dkf, dvf = fa._launch_dkv(*own, inv_l=inv_l)
    assert torch.equal(out, o)
    assert torch.equal(leaves[0].grad, fa._launch_dq(*own, inv_l=inv_l))
    assert torch.equal(leaves[1].grad, dkf) and torch.equal(leaves[2].grad, dvf)


@pytest.mark.parametrize("B,nh,L,dtype", [(68, 12, 384, torch.bfloat16), (5, 4, 256, torch.float16)])
def test_flash_rows_kernel(cuda_device, B, nh, L, dtype):
    """The backward's rows kernel: di bit-equal to its order emulated in
    torch and within fp32 rounding of ``flash_di`` (2 * 64 * 2^-24 * sum |o *
    do| a row), 1 / l bit-equal to the division in torch; read in the models'
    layout."""
    from colbert_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(cuda_device).manual_seed(L + B)
    o, do = (torch.randn((B, L, nh, 64), generator=g, device=cuda_device).to(dtype).transpose(1, 2)
             for _ in range(2))
    l = torch.rand((B, nh, L), generator=g, device=cuda_device) * 100 + 1
    before = fa.rows_launches.value
    di, inv_l = fa._launch_rows(o, do, l)
    torch.cuda.synchronize()
    assert fa.rows_launches.value == before + 1
    assert torch.equal(di, fa.flash_di_card_order(o, do))
    bound = 2 * 64 * 2.0**-24 * (o.float() * do.float()).abs().sum(-1)
    assert bool(((di - fa.flash_di(o, do)).abs() <= bound).all())
    assert torch.equal(inv_l, torch.ones_like(l) / l)


def test_flash_refuses_what_it_does_not_take(cuda_device):
    """On a CUDA tensor the wrapper launches or raises, never the plain version."""
    from colbert_tpu_torch.ops import flash_attention as fa

    seg = torch.ones((2, 384), dtype=torch.int32, device=cuda_device)
    for shape, dtype in (((2, 2, 384, 32), torch.bfloat16), ((2, 2, 384, 64), torch.float32)):
        x = torch.zeros(shape, dtype=dtype, device=cuda_device)
        with pytest.raises(NotImplementedError, match="step 12"):
            fa.flash_attention(x, x, x, seg, seg, 0.125)
    x = torch.zeros((2, 2, 200, 64), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(NotImplementedError, match="step 12"):
        fa.flash_attention(x, x, x, seg[:, :200], seg[:, :200], 0.125)


@pytest.mark.parametrize("num_layers,remat", [(2, "none"), (2, "full"), (12, "none")])
def test_flash_launches_per_train_step(cuda_device, num_layers, remat):
    """A retriever step with flash: docs at 128 launch K11, K12 and K13 once a
    layer each (K11 twice under remat "full": the recompute), queries at 32
    none; K9 at every dropout site, forward and backward."""
    from colbert_tpu_torch.config import ModelConfig, MultiviewConfig
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.ops import dropout as dr, flash_attention as fa

    cfg = ModelConfig(vocab_size=128, hidden_size=128, num_layers=num_layers, num_heads=2, intermediate_size=256,
                      max_position_embeddings=128, dim=32, attention_impl="flash", remat=remat)
    m = ColbertModel(cfg, MultiviewConfig())
    m.init_weights(torch.Generator().manual_seed(0))
    m = m.to(cuda_device).train()
    g = torch.Generator().manual_seed(1)
    d_ids, q_ids = torch.randint(1, 128, (6, 128), generator=g), torch.randint(1, 128, (2, 32), generator=g)
    d_attn = (torch.arange(128)[None, :] < torch.tensor([128, 100, 60, 129 - 1, 33, 5])[:, None]).long()
    counters = (fa.fwd_launches, fa.dkv_launches, fa.dq_launches, dr.hw_dropout.launches,
                fa.fwd_route_launches["wgmma"], fa.dkv_route_launches["wgmma"], fa.dq_route_launches["wgmma"],
                fa.rows_launches)
    before = [c.value for c in counters]
    D = m.doc(d_ids.to(cuda_device), d_attn.to(cuda_device), generator=torch.Generator().manual_seed(2))
    Q = m.query(q_ids.to(cuda_device), torch.ones_like(q_ids).to(cuda_device), generator=torch.Generator().manual_seed(3))
    (torch.einsum("qmh,dnh->qd", Q, D).sum()).backward()
    torch.cuda.synchronize()
    got = [c.value - b for c, b in zip(counters, before)]
    # K9: two passes, forward and backward, at 1 + 3 sites a layer; "full"
    # runs each layer's three sites again in the recompute
    k9 = 2 * 2 * (1 + 3 * num_layers) + (2 * 3 * num_layers if remat == "full" else 0)
    k11 = num_layers * (2 if remat == "full" else 1)
    assert got == [k11, num_layers, num_layers, k9, k11, num_layers, num_layers, num_layers]  # all on "wgmma"


@pytest.mark.parametrize("attention_impl", ["xla", "flash"])
def test_train_step_gradients_bit_equal(cuda_device, attention_impl):
    """A retriever step's forward and backward three times on the same inputs
    gives every gradient the same bits (what resume and remat rely on): one
    layer at BERT-base width, docs of 384 tokens at a batch of 68 (26,112
    ids, every token type 0) from a 128-word vocabulary, so every id repeats;
    queries of 32 padded with one id; explicit and flash attention.  With
    ``F.embedding`` in place of the model's ``lookup`` this failed: its
    backward on the card summed the ~200 rows of each word id in an order
    that varied from run to run.  The lookup's backward is
    ``models.bert.lookup_backward``, which sets no process-wide flag."""
    from colbert_tpu_torch.config import ModelConfig, MultiviewConfig
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.ops.dropout import same_bits

    cfg = ModelConfig(vocab_size=128, hidden_size=768, num_layers=1, num_heads=12, intermediate_size=3072,
                      max_position_embeddings=384, dim=128, dtype="bfloat16", attention_impl=attention_impl)
    m = ColbertModel(cfg, MultiviewConfig())
    m.init_weights(torch.Generator().manual_seed(0))
    m = m.to(cuda_device).train()
    g = torch.Generator().manual_seed(1)
    d_ids, q_ids = torch.randint(1, 128, (68, 384), generator=g), torch.randint(1, 128, (34, 32), generator=g)
    d_attn = (torch.arange(384)[None, :] < torch.randint(16, 385, (68, 1), generator=g)).long()
    q_ids[:, 12:] = 4  # the padding id
    d_ids, q_ids, d_attn = d_ids.to(cuda_device), q_ids.to(cuda_device), d_attn.to(cuda_device)

    def grads():
        m.zero_grad(set_to_none=True)
        D = m.doc(d_ids, d_attn, generator=torch.Generator().manual_seed(2))
        Q = m.query(q_ids, torch.ones_like(q_ids), generator=torch.Generator().manual_seed(3))
        torch.einsum("qmh,dnh->qd", Q.float(), D.float()).logsumexp(-1).sum().backward()
        return {k: p.grad.clone() for k, p in m.named_parameters() if p.grad is not None}
    first = grads()
    assert len(first) == len(list(m.parameters()))
    for _ in range(2):
        again = grads()
        assert [k for k in first if not same_bits(first[k], again[k])] == []


@pytest.mark.parametrize("rows,n,span", [(2, 26_112, 1), (21_128, 26_112, 2_001), (128, 26_112, 128)])
def test_lookup_backward_on_the_card(cuda_device, monkeypatch, rows, n, span):
    """The embeddings' backward on the card (``models.bert.lookup_backward``:
    the one-hot product for the 2-row token types, the sorted two-level sum
    for the doc pass's words and a 128-word vocabulary): three runs bit-equal;
    ``F.embedding``'s gradient bit for bit where every fp32 sum is exact
    (quarter integers), and within fp32 rounding of the float64 sums on random
    values; and through ``lookup``'s autograd, with
    ``torch.use_deterministic_algorithms`` patched to raise, the global flag
    never set (read in a hook on the lookup's output gradient and after)."""
    import torch.nn.functional as F

    from colbert_tpu_torch.models import bert

    g = torch.Generator().manual_seed(rows)
    ids = torch.randint(0, span, (n,), generator=g)
    ids[torch.rand(n, generator=g) < 0.7] = 0  # one id on most rows, as padding is at the doc pass
    ids = ids.to(cuda_device)
    exact = (torch.randint(-8, 9, (n, 768), generator=g).float() / 4).to(cuda_device)
    w = torch.zeros((rows, 768), device=cuda_device, requires_grad=True)
    F.embedding(ids, w).backward(exact)
    up = torch.randn((n, 768), generator=g).to(cuda_device).bfloat16()
    runs = [bert.lookup_backward(ids, up, rows) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(r.view(torch.int16), runs[0].view(torch.int16)) for r in runs[1:])
    assert torch.equal(bert.lookup_backward(ids, exact.bfloat16(), rows), w.grad.bfloat16())
    want = torch.zeros((rows, 768), dtype=torch.float64, device=cuda_device).index_add_(0, ids, up.double())
    mags = torch.zeros_like(want).index_add_(0, ids, up.double().abs())
    assert bool(((runs[0].double() - want).abs() <= n * 2.0**-24 * mags + 2.0**-7 * want.abs()).all())

    def refuse(*a, **kw):
        raise AssertionError("torch.use_deterministic_algorithms called")
    monkeypatch.setattr(torch, "use_deterministic_algorithms", refuse)
    seen = []
    weight = torch.zeros((rows, 768), device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
    out = bert.lookup(ids, weight)
    out.register_hook(lambda gr: seen.append(torch.are_deterministic_algorithms_enabled()))
    out.backward(up)
    torch.cuda.synchronize()
    seen.append(torch.are_deterministic_algorithms_enabled())
    assert seen == [False, False] and torch.equal(weight.grad, runs[0])


def test_flash_launches_per_ce_step(cuda_device, tmp_path):
    """A macbert-large-deep (24 layers) CE step with flash at ce_maxlen 128:
    K11, K12 and K13 24 launches each, K9 146, all on route "packed"."""
    from colbert_tpu_torch.config import CETrainConfig, ColbertConfig, ModelConfig, TokenizerConfig
    from colbert_tpu_torch.ops import dropout as dr, flash_attention as fa
    from colbert_tpu_torch.tokenization import ColbertTokenizer, build_vocab, write_vocab
    from colbert_tpu_torch.training import CETrainer

    words = ["apple", "river", "piano", "ocean", "forest"]
    vp = write_vocab(build_vocab([" ".join(words)]), tmp_path / "vocab.txt")
    cfg = ColbertConfig(
        ce_model=ModelConfig(vocab_size=128, hidden_size=128, num_layers=24, num_heads=2, intermediate_size=256,
                             max_position_embeddings=128, dtype="bfloat16", attention_impl="flash"),
        tokenizer=TokenizerConfig(vocab_path=vp, ce_maxlen=128),
        ce_train=CETrainConfig(per_device_batch_size=2, neg_num=2, neg_pool_lo=0, neg_pool_hi=4,
                               checkpoint_dir=str(tmp_path / "ce")),
    )
    exs = [{"question": w, "positive_ctxs": [w + " " + w], "hard_negative_ctxs": [o for o in words if o != w]}
           for w in words[:2]]
    t = CETrainer(cfg, ColbertTokenizer(cfg.tokenizer, cfg.multiview), device=cuda_device)
    t._init_state(2)
    ids, attn, group, teacher = t._build_pairs(exs, "train")
    counters = (fa.fwd_launches, fa.dkv_launches, fa.dq_launches, dr.hw_dropout.launches,
                dr.route_launches["packed"])
    before = [c.value for c in counters]
    loss = t.train_step(ids, attn, group, teacher, 0)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert [c.value - b for c, b in zip(counters, before)] == [24, 24, 24, 146, 146]
