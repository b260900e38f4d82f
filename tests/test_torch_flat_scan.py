"""The port's flat scan (``colbert_tpu_torch.ops.flat_scan``) against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as ``tests/test_flat_scan.py`` runs
them.  Inputs are numpy arrays made from a seed and handed to both.

Tolerances: bf16 x bf16 products are exact in fp32, so fp32 scores differ
only by summation order (rtol/atol 1e-5); a bf16 stored score may differ by
one bf16 ulp of its value, since a last-bit fp32 difference can flip the
rounding.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from colbert_tpu.ops import flat_scan as jfs
from colbert_tpu_torch.ops import flat_scan as tfs


@pytest.fixture(autouse=True)
def jax_native_off(monkeypatch):
    """The JAX package takes its numpy fallbacks, which compute the same
    functions: its tracked native library is compiled with -march=native
    for another CPU and can stop the test process with an illegal
    instruction."""
    import colbert_tpu.native.lib as native

    monkeypatch.setattr(native, "_load", lambda: None)


def _corpus(seed, num_docs, h, uniform, dv=6):
    rng = np.random.default_rng(seed)
    doclens = np.full(num_docs, dv) if uniform else rng.integers(1, dv + 1, size=num_docs)
    emb = rng.normal(size=(int(doclens.sum()), h)).astype(np.float16)
    return emb, doclens


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = np.frexp(np.maximum(np.abs(x), np.finfo(np.float32).tiny))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("uniform", [True, False])
def test_build_flat_table_bit_equal(dtype, uniform):
    emb, doclens = _corpus(0, 41, 64, uniform)
    jt, jinv, jdv = jfs.build_flat_table(emb, doclens, dtype=dtype)
    tt, tinv, tdv = tfs.build_flat_table(emb, doclens, dtype=dtype)
    assert tdv == jdv and tuple(tt.shape) == jt.shape
    if dtype == "bfloat16":
        assert jt.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(tt.view(torch.int16).numpy(), jt.view(np.int16))
    else:
        np.testing.assert_array_equal(tt.numpy(), jt)
        np.testing.assert_array_equal(tinv.numpy(), jinv)


# hidden dims that are not a multiple of 16 (the TPU kernels take any h; the
# TinyBERT-4L-zh width's dim = hidden is 312): cases beside the 128 and 64
# ones, which keep their ids
ODD_H = (24, 100, 312)


def _cases(base, extra):
    """``base`` cases with their old ids, then ``extra`` ones named by their values."""
    return [pytest.param(*c, id=i) for c, i in base] + [pytest.param(*c, id="-".join(map(str, c))) for c in extra]


@pytest.mark.parametrize("uniform,h,dtype", _cases(
    [((True, 128, "bfloat16"), "True"), ((False, 128, "bfloat16"), "False")],
    [(u, h, dt) for h in ODD_H for dt in ("bfloat16", "int8") for u in (True, False)]))
def test_flat_maxsim_scan_matches_jax(uniform, h, dtype):
    """K2 over a bf16 or int8 table (int8: the descale folded into the queries)."""
    emb, doclens = _corpus(1, 37, h, uniform)
    rng = np.random.default_rng(2)
    B, m = 5, 4
    Qm = rng.normal(size=(B, m, h)).astype(np.float32)
    Qm[1, 2:] = 0.0
    jt, jinv, dv = jfs.build_flat_table(emb, doclens, dtype=dtype)
    tt, _, _ = tfs.build_flat_table(emb, doclens, dtype=dtype)
    if jinv is not None:
        Qm = Qm * jinv
    got = tfs.flat_maxsim_scan(torch.from_numpy(Qm), tt, dv=dv).numpy()

    rb = jfs.pick_rows_block(dv, jt.dtype.itemsize, target_rows=64)
    want = np.asarray(jfs.flat_maxsim_scan(jnp.asarray(Qm), jnp.asarray(jt), dv=dv, rows_blk=rb))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if dtype == "int8":
        return
    # the XLA reference scans an fp32 copy of the table with bf16-rounded queries
    Qb = Qm.astype(ml_dtypes.bfloat16).astype(np.float32)
    xla = np.asarray(jfs.flat_maxsim_scan_xla(jnp.asarray(Qb), jnp.asarray(jt.astype(np.float32)), dv=dv))
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-5)


def test_flat_maxsim_scan_int8_matches_jax():
    emb, doclens = _corpus(3, 29, 128, True, dv=4)
    rng = np.random.default_rng(4)
    Qm = rng.normal(size=(3, 4, 128)).astype(np.float32)
    jt, jinv, dv = jfs.build_flat_table(emb, doclens, dtype="int8")
    tt, tinv, _ = tfs.build_flat_table(emb, doclens, dtype="int8")
    Qs = Qm * jinv  # the searcher folds the per-dim descale into the queries
    got = tfs.flat_maxsim_scan(torch.from_numpy(Qs), tt, dv=dv).numpy()
    rb = jfs.pick_rows_block(dv, 1, target_rows=64)
    want = np.asarray(jfs.flat_maxsim_scan(jnp.asarray(Qs), jnp.asarray(jt), dv=dv, rows_blk=rb))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("score_dtype,h,dtype", _cases(
    [(("float32", 64, "bfloat16"), "float32"), (("bfloat16", 64, "bfloat16"), "bfloat16")],
    [(s, h, dt) for h in ODD_H for dt in ("bfloat16", "int8") for s in ("float32", "bfloat16")]))
def test_flat_scan_topk_matches_jax(score_dtype, h, dtype):
    """K1 and the exact stage-2 top-k over a bf16 or int8 table."""
    # 45 docs at dv=4: the port's group is 64 docs and the JAX rows block 16
    # docs, so num_docs ends inside a group on both sides
    rng = np.random.default_rng(5)
    num_docs, dv, B, m, k = 45, 4, 6, 4, 10
    emb = rng.normal(size=(num_docs * dv, h)).astype(np.float16)
    doclens = np.full(num_docs, dv)
    Qm = rng.normal(size=(B, m, h)).astype(np.float32)
    rows_blk = 64 if dtype == "bfloat16" else 128  # the int8 table's rows block: whole 32-row sublane tiles
    jt, jinv, _ = jfs.build_flat_table(emb, doclens, dtype=dtype, rows_blk=rows_blk)
    tt, _, _ = tfs.build_flat_table(emb, doclens, dtype=dtype, rows_blk=rows_blk)
    if jinv is not None:
        Qm = Qm * jinv  # the searcher folds the per-dim descale into the queries
    # pad docs beyond num_docs must never be returned even with large scores
    assert tt.shape[0] // dv > num_docs

    ts, tp = tfs.flat_scan_topk(torch.from_numpy(Qm), tt, dv=dv, num_docs=num_docs,
                                topk=k, score_dtype=score_dtype)
    ts, tp = ts.numpy(), tp.numpy()
    js, jp = jfs.flat_scan_topk(jnp.asarray(Qm), jnp.asarray(jt), dv=dv, num_docs=num_docs,
                                topk=k, rows_blk=rows_blk, score_dtype=score_dtype)
    js, jp = np.asarray(js), np.asarray(jp)

    tol = 1e-5 * np.maximum(1.0, np.abs(js))
    if score_dtype == "bfloat16":
        tol = tol + _bf16_ulp(js)
    assert (np.abs(ts - js) <= tol).all()
    assert ((tp >= 0) & (tp < num_docs)).all()
    # pids agree except at ties, and a tie is judged by score
    full = tfs.flat_maxsim_scan_ref(torch.from_numpy(Qm), tt, dv=dv).numpy()
    b, j = np.nonzero(tp != jp)
    assert (np.abs(full[tp[b, j], b] - full[jp[b, j], b]) <= 2 * tol[b, j]).all()


@pytest.mark.parametrize("segment", [64, 3])
def test_flat_topk_segmented_matches_single(segment):
    rng = np.random.default_rng(6)
    s = torch.from_numpy(rng.normal(size=(300, 4)).astype(np.float32))
    a_s, a_i = tfs.flat_topk(s, 250, 7)
    b_s, b_i = tfs.flat_topk(s, 250, 7, segment=segment)
    np.testing.assert_array_equal(a_s.numpy(), b_s.numpy())
    np.testing.assert_array_equal(a_i.numpy(), b_i.numpy())
    assert (a_i.numpy() < 250).all()
    j_s, j_i = jfs.flat_topk(jnp.asarray(s.numpy()), 250, 7)
    np.testing.assert_array_equal(a_s.numpy(), np.asarray(j_s))
    np.testing.assert_array_equal(a_i.numpy(), np.asarray(j_i))


def test_cuda_wrapper_refuses_mixed_devices():
    """Off the CPU the wrappers launch the kernel or raise: never the plain path."""
    Qm = torch.zeros(1, 1, 16)
    table = torch.zeros(4, 16, dtype=torch.bfloat16, device="meta")
    before = (tfs.flat_maxsim_scan.launches.value, tfs.flat_scan_fused.launches.value)
    with pytest.raises(ValueError, match="CUDA"):
        tfs.flat_maxsim_scan(Qm, table, dv=4)
    with pytest.raises(ValueError, match="CUDA"):
        tfs.flat_scan_fused(Qm, table, dv=4, num_docs=1, score_dtype="float32")
    assert (tfs.flat_maxsim_scan.launches.value, tfs.flat_scan_fused.launches.value) == before



@pytest.mark.parametrize("group", [1, 8, 64, 1000])
def test_select_topk_equals_a_full_topk(group):
    """Stage 2 is exact for any group size: 300 docs end inside a group of
    8 and of 64 (and 1,000 is one group past docs_pad); scores on a 1/8
    grid tie often; docs past num_docs hold -inf as K1 writes them."""
    rng = np.random.default_rng(group)
    docs_pad, B, num_docs, k = 300, 5, 291, 20
    s = torch.from_numpy(rng.integers(-40, 40, size=(docs_pad, B)).astype(np.float32) / 8)
    s[num_docs:] = float("-inf")
    n_groups = -(-docs_pad // group)
    padded = torch.full((n_groups * group, B), float("-inf"))
    padded[:docs_pad] = s
    gmax = padded.view(n_groups, group, B).amax(dim=1)
    ts, tp = tfs.select_topk(s, gmax, group=group, num_docs=num_docs, topk=k)
    want, _ = torch.topk(s[:num_docs].T, k, dim=1)
    assert torch.equal(ts, want)
    assert ((tp >= 0) & (tp < num_docs)).all()
    assert torch.equal(s[tp.long(), torch.arange(B)[:, None]], ts)
    assert all(len(set(row)) == k for row in tp.tolist())


@pytest.mark.parametrize("dv,m,route", [
    (16, 16, "wgmma"),    # multiview: a warp's 16 accumulator rows are one doc
    (1, 16, "staged"),
    (37, 16, "staged"),   # ragged corpora padded to their longest doc
    (64, 16, "staged"),
    (384, 16, "staged"),  # a doc over several row tiles
    (16, 32, "staged"),
    (5, 32, "staged"),
])
def test_flat_scan_plan_routes(dv, m, route):
    assert tfs.flat_scan_plan(dv, m) == route
