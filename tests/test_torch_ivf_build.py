"""The port's IVF index build against the JAX package on the CPU: Lloyd
iterations from JAX's own initial points, nearest-centroid candidates, the
sq codec, CSR packing, balanced assignment, and the files ``build-index``
writes.

The JAX package's native host library is switched off in every test here
(its numpy fallbacks compute the same functions): the tracked library is
compiled with ``-march=native`` for another CPU and can stop the process
with an illegal instruction.

Limits: centroids within 1e-4 (bf16 products are exact in fp32; the sums
run in another order), assignments >= 99.9% equal (a point equidistant to
two centroids within rounding may go either way), ``proj`` within 1e-4 up
to the sign of each column (``eigh`` fixes no sign), everything else exact.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.indexing import IndexBuilder as JaxBuilder
from colbert_tpu.indexing import IndexStorage as JaxStorage
from colbert_tpu_torch.config import ColbertConfig, IndexConfig
from colbert_tpu_torch.indexing.builder import IndexBuilder, auto_partitions
from colbert_tpu_torch.indexing.storage import IndexStorage
from colbert_tpu_torch.ops import ivf as pivf
from colbert_tpu_torch.ops import kmeans as pkm
from colbert_tpu_torch.ops import sq as psq

# The tests run in several workers at once beside JAX's own thread pools:
# two intra-op threads per worker keep the CPU from being oversubscribed.
torch.set_num_threads(2)

# the modules, not the functions of the same name that colbert_tpu.ops exports
jkm = importlib.import_module("colbert_tpu.ops.kmeans")
jsq = importlib.import_module("colbert_tpu.ops.sq")


@pytest.fixture
def jax_native_off(monkeypatch):
    """The JAX package takes its numpy fallbacks (see the module docstring)."""
    import colbert_tpu.native.lib as native

    monkeypatch.setattr(native, "_load", lambda: None)


def clustered(seed, n, d, k, spread=0.15):
    rng = np.random.default_rng(seed)
    cent = rng.normal(size=(k, d)).astype(np.float32)
    x = cent[rng.integers(0, k, size=n)] + spread * rng.normal(size=(n, d)).astype(np.float32)
    return x.astype(np.float32)


@pytest.mark.parametrize("n,d,k,chunk", [(2000, 32, 16, 512), (700, 24, 31, 256)])
def test_lloyd_from_jax_initial_points(n, d, k, chunk):
    x = clustered(n + k, n, d, k)
    key = jax.random.PRNGKey(k)
    want_c, want_a = jkm.kmeans(jnp.asarray(x), k, iters=6, key=key, chunk=chunk, init="random")
    idx = np.asarray(jax.random.choice(key, n, shape=(k,), replace=n < k))  # kmeans.py:124
    got_c = pkm.lloyd(torch.from_numpy(x), torch.from_numpy(x[idx]), iters=6, chunk=chunk)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=1e-4)
    got_a = pkm.assign_clusters(torch.from_numpy(x), got_c, chunk=chunk).numpy()
    assert (got_a == np.asarray(want_a)).mean() >= 0.999
    # given the same centroids, assignment and the nearest-centroid lists are exact
    np.testing.assert_array_equal(pkm.assign_clusters(torch.from_numpy(x), torch.from_numpy(np.asarray(want_c))).numpy(),
                                  np.asarray(want_a))
    np.testing.assert_array_equal(
        pkm.nearest_centroids(torch.from_numpy(x), torch.from_numpy(np.asarray(want_c)), 4).numpy(),
        np.asarray(jkm.nearest_centroids(jnp.asarray(x), want_c, 4)))


@pytest.mark.parametrize("init", ["random", "kmeans++", "auto"])
def test_kmeans_inits_give_valid_clusterings(init):
    x = torch.from_numpy(clustered(3, 600, 16, 8, spread=0.05))
    c, a = pkm.kmeans(x, 8, iters=10, generator=torch.Generator().manual_seed(0), chunk=128, init=init)
    assert c.shape == (8, 16) and a.dtype == torch.int32
    assert torch.isfinite(c).all() and 0 <= int(a.min()) and int(a.max()) < 8
    inertia = float(((x - c[a.long()]) ** 2).sum(dim=1).mean())
    spread = float(((x - x.mean(dim=0)) ** 2).sum(dim=1).mean())
    assert inertia < 0.5 * spread  # a clustering, not one blob


@pytest.mark.parametrize("sq_dim", [16, 64])
def test_sq_codec_matches_jax(sq_dim):
    rng = np.random.default_rng(sq_dim)
    d = 96
    # well separated eigenvalues: an eigenvector's rounding error scales as
    # eps / (the gap to its neighbours)
    spectrum = np.sqrt(np.linspace(1.0, 0.05, d))
    x = (rng.normal(size=(4000, d)) * spectrum).astype(np.float32)
    jproj, jscales = jsq.sq_train(jnp.asarray(x), sq_dim)
    proj, scales = psq.sq_train(torch.from_numpy(x), sq_dim)
    jproj, jscales = np.asarray(jproj), np.asarray(jscales)
    sign = np.sign((proj.numpy() * jproj).sum(axis=0))
    assert (np.abs(sign) == 1).all()
    np.testing.assert_allclose(proj.numpy() * sign, jproj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(scales.numpy(), jscales, rtol=1e-4)
    # codes exact given the same proj/scales; inputs with few significant
    # bits make every product and sum exact, so no order of summation can
    # move a value across a rounding boundary
    xq = np.round(x * 8) / 8
    pq = np.round(jproj * 1024) / 1024
    want = np.asarray(jsq.sq_encode(jnp.asarray(xq), jnp.asarray(pq), jnp.asarray(jscales), chunk=512))
    got = psq.sq_encode(torch.from_numpy(xq), torch.from_numpy(pq), torch.from_numpy(jscales), chunk=512)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    q = rng.normal(size=(7, d)).astype(np.float32)
    np.testing.assert_allclose(psq.sq_query(torch.from_numpy(q), torch.from_numpy(jproj), torch.from_numpy(jscales)).numpy(),
                               np.asarray(jsq.sq_query(jnp.asarray(q), jnp.asarray(jproj), jnp.asarray(jscales))),
                               rtol=1e-5, atol=1e-7)


def test_csr_pack_and_balanced_assign_match_jax(jax_native_off):
    from colbert_tpu.native import balanced_assign as j_balanced, ivf_pack as j_pack
    from colbert_tpu.ops.ivf import sort_by_list as j_sort

    rng = np.random.default_rng(5)
    K, n = 13, 900
    assign = rng.integers(0, K, size=n).astype(np.int32)
    assign[assign == 4] = 5  # an empty list
    codes = rng.integers(-127, 128, size=(n, 16)).astype(np.int8)
    perm, offsets, sorted_codes = pivf.ivf_pack(assign, codes, K)
    jperm, joff, jcodes = j_pack(assign, codes.view(np.uint8), K)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(offsets, joff)
    np.testing.assert_array_equal(sorted_codes, jcodes.view(np.int8))
    assert perm.dtype == np.int32 and offsets.dtype == np.int32
    for got, want in zip(pivf.sort_by_list(assign, K), j_sort(assign, K)):
        np.testing.assert_array_equal(got, want)
    cand = np.stack([rng.permutation(K)[:4] for _ in range(n)]).astype(np.int32)
    cand[::50, :] = 0  # many points wanting list 0 spill
    cap = int(np.ceil(n / K * 1.2))
    got = pivf.balanced_assign(cand, K, cap)
    np.testing.assert_array_equal(got, j_balanced(cand, K, cap))
    assert np.bincount(got, minlength=K).max() <= cap + 1


def test_auto_partitions_matches_jax():
    from colbert_tpu.indexing.builder import auto_partitions as j_auto

    for n in (1, 17, 5000, 320_000, 3_200_000):
        assert auto_partitions(n) == j_auto(n)
    assert auto_partitions(320_000) == 4096


def _write_parts(path, storage_cls, rng, dims=(64,), n_docs=(40, 35, 30), dv=8):
    st = storage_cls(path)
    dim = dims[0]
    for p, nd in enumerate(n_docs):
        e = rng.normal(size=(nd * dv, dim)).astype(np.float32)
        e /= np.linalg.norm(e, axis=1, keepdims=True)
        st.write_part(p, e.astype(np.float16), [dv] * nd)
    st.write_meta({"dim": dim, "num_docs": sum(n_docs), "num_embeddings": sum(n_docs) * dv,
                   "multiview": True, "d_view": dv, "num_parts": len(n_docs),
                   "embedding_dtype": "float16"})
    return st


def _build_both(tmp_path, index, patch=None):
    """Build the JAX and the port index over one set of parts (``patch``
    runs on the port's builder module first); returns both storages."""
    import shutil

    from colbert_tpu.config import ColbertConfig as JaxConfig, IndexConfig as JaxIndexConfig

    _write_parts(tmp_path / "jax", JaxStorage, np.random.default_rng(0))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    JaxBuilder(JaxConfig(index=JaxIndexConfig(index_path=str(tmp_path / "jax"), **index)),
               JaxStorage(tmp_path / "jax")).build(chunk=256)
    IndexBuilder(ColbertConfig(index=IndexConfig(index_path=str(tmp_path / "port"), **index)),
                 IndexStorage(tmp_path / "port"), device="cpu").build(chunk=256)
    return JaxStorage(tmp_path / "jax"), IndexStorage(tmp_path / "port")


def _assert_same_layout(tmp_path, jst, pst):
    """Same files, dtypes, shapes and meta keys; a consistent CSR layout."""
    jivf, pivf_ = jst.read_ivf(), pst.read_ivf()
    assert sorted(jivf) == sorted(pivf_)
    for name in jivf:
        assert pivf_[name].dtype == jivf[name].dtype and pivf_[name].shape == jivf[name].shape, name
    files = lambda p: sorted(str(f.relative_to(p)) for f in p.rglob("*.npy"))
    assert files(tmp_path / "jax") == files(tmp_path / "port")
    jm, pm = jst.read_meta(), pst.read_meta()
    assert sorted(jm) == sorted(pm)
    drop = lambda m: {k: v for k, v in m.items() if k != "build_timers"}
    assert drop(jm) == drop(pm)
    assert sorted(jm["build_timers"]) == sorted(pm["build_timers"])
    # the CSR layout is consistent: each list's rows carry codes of its members
    off = pivf_["offsets"]
    assert off[0] == 0 and off[-1] == pivf_["codes"].shape[0] and (np.diff(off) >= 0).all()
    np.testing.assert_array_equal(np.sort(pivf_["row_emb"]), np.arange(off[-1]))
    np.testing.assert_array_equal(pivf_["emb2pid"], jivf["emb2pid"])


@pytest.mark.parametrize("balance", [0.0, 1.3])
def test_build_index_writes_the_same_files(tmp_path, jax_native_off, balance):
    """Same files, dtypes, shapes and meta keys as the JAX builder over one
    set of parts (values differ: the k-means initial points are drawn from
    different generators)."""
    index = dict(codec="sq", sq_dim=16, partitions=12, kmeans_iters=4, train_sample_parts=2,
                 max_train_points=500, balance_factor=balance)
    _assert_same_layout(tmp_path, *_build_both(tmp_path, index))


PQ_INDEX = {"pq": dict(pq_m=16, pq_nbits=8), "pq4": dict(pq4_m=32)}


@pytest.mark.parametrize("codec", ["pq", "pq4"])
def test_build_index_pq_codecs_write_the_same_files(tmp_path, jax_native_off, codec):
    """The pq codecs: uint8 (pq) or packed int8 (pq4) codes, codebooks.npy,
    bytes_per_vector, and the same keys as the JAX builder."""
    index = dict(codec=codec, partitions=12, kmeans_iters=3, pq_kmeans_iters=3, train_sample_parts=2,
                 max_train_points=500, **PQ_INDEX[codec])
    jst, pst = _build_both(tmp_path, index)
    _assert_same_layout(tmp_path, jst, pst)
    codes = pst.read_ivf()["codes"]
    assert codes.dtype == (np.uint8 if codec == "pq" else np.int8)
    assert pst.read_meta()["bytes_per_vector"] == {"pq": 16, "pq4": 16}[codec] == codes.shape[1]


@pytest.mark.parametrize("codec", ["pq", "pq4"])
def test_build_index_pq_codecs_from_jax_initial_points(tmp_path, jax_native_off, monkeypatch, codec):
    """Given JAX's own initial points for the coarse k-means and the PQ
    codebooks, the port's builder writes the JAX builder's index: centroids
    and codebooks within 1e-4, assignments and codes of each embedding equal
    but for a few points within rounding of a tie."""
    from colbert_tpu_torch.indexing import builder as pbuild
    from colbert_tpu_torch.ops import pq as ppq

    key = jax.random.PRNGKey(ColbertConfig().train.seed)  # the JAX builder's key for both

    def jax_kmeans(x, k, *, iters, generator, chunk):
        xs = jnp.asarray(x.numpy())
        c0 = (jkm.kmeans_plusplus_init(xs, k, key) if k <= 1024
              else xs[jax.random.choice(key, xs.shape[0], shape=(k,), replace=xs.shape[0] < k)])
        c = pkm.lloyd(x, torch.from_numpy(np.array(c0)), iters, chunk=chunk)
        return c, pkm.assign_clusters(x, c, chunk=chunk)

    def jax_pq(x, m, ksub=16, *, iters, generator, chunk):
        n, d = x.shape
        idx = np.asarray(jax.random.choice(key, n, shape=(ksub,), replace=n < ksub))  # pq.py:56
        cb0 = x.numpy()[idx].reshape(ksub, m, d // m).transpose(1, 0, 2).copy()
        return ppq.pq_lloyd(x, torch.from_numpy(cb0), iters, chunk=chunk)

    monkeypatch.setattr(pbuild, "kmeans", jax_kmeans)
    monkeypatch.setattr(pbuild, "pq_train" if codec == "pq" else "pq4_train", jax_pq)
    index = dict(codec=codec, partitions=12, kmeans_iters=3, pq_kmeans_iters=3, train_sample_parts=2,
                 max_train_points=500, **PQ_INDEX[codec])
    jst, pst = _build_both(tmp_path, index)
    j, p = jst.read_ivf(), pst.read_ivf()
    for name in ("coarse_centroids", "codebooks"):
        np.testing.assert_allclose(p[name], j[name], rtol=0, atol=1e-4, err_msg=name)
    by_emb = lambda ivf, a: a[np.argsort(ivf["row_emb"], kind="stable")]
    list_of = lambda ivf: by_emb(ivf, np.repeat(np.arange(len(ivf["offsets"]) - 1), np.diff(ivf["offsets"])))
    assert (list_of(p) == list_of(j)).mean() >= 0.99
    assert (by_emb(p, p["codes"]) == by_emb(j, j["codes"])).all(axis=1).mean() >= 0.97
