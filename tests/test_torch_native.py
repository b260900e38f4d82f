"""The port's C++ host runtime (``colbert_tpu_torch/csrc/native.cpp``) on the CPU.

The library is built with g++ here as on any host, so these tests run the
C++ itself: the response serializer against its Python plain version and
the JAX package's Python path (byte for byte), the CSR pack and the
balanced assignment against their plain versions (element for element),
and the g++ build's failure and concurrency rules.  The JAX package's
native library is switched off while its serializer runs: the tracked
library is built with ``-march=native`` for another CPU.
"""

import pickle
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from colbert_tpu_torch import native
from colbert_tpu_torch.config import ColbertConfig
from colbert_tpu_torch.ops import _build
from colbert_tpu_torch.ops import ivf as pivf
from colbert_tpu_torch.serving.serializer import TripleSerializer
from colbert_tpu_torch.serving.server import RetrievalService

REPO = Path(__file__).resolve().parent.parent

# Chinese, 4-byte characters (UTF-8 of 4 bytes each), an empty text, ASCII
CORPUS = ["", "北京是中国的首都", "emoji 😀 and 𝄞 and 𠀋", "plain ascii passage",
          "多行\n文本\t制表符", "🀄" * 40] + [f"文档 {i} " + "字" * (i % 17) for i in range(40)]


@pytest.fixture
def jax_native_off(monkeypatch):
    import colbert_tpu.native.lib as jnative

    monkeypatch.setattr(jnative, "_load", lambda: None)


def batch_case(name, seed=0, nq=6, k=9):
    """(pids, scores) of one response batch: -1 padding, a row of all -1,
    scores of the case's dtype with NaN and +-inf where the case asks."""
    rng = np.random.default_rng(seed)
    pids = rng.integers(0, len(CORPUS), size=(nq, k)).astype(np.int32)
    pids[1, 5:] = -1
    pids[2] = -1
    pids[3, ::2] = -1
    pids[4, 0] = 0  # the empty text
    dtype = np.float64 if name.startswith("fp64") else np.float32
    scores = (rng.normal(size=(nq, k)) * 10).astype(dtype)
    if name.endswith("special"):
        neg_nan = np.array(np.nan, dtype)
        neg_nan = np.copysign(neg_nan, -1.0).astype(dtype)
        scores[0, :5] = [np.nan, np.inf, -np.inf, -0.0, neg_nan]
        scores[5, -1] = np.finfo(dtype).tiny / 2  # subnormal
    return pids, scores


@pytest.mark.parametrize("case", ["fp32", "fp64", "fp32 special", "fp64 special"])
def test_payload_bytes_equal_plain_and_jax(case, jax_native_off):
    from colbert_tpu.serving.serializer import TripleSerializer as JaxSerializer

    ser, jser = TripleSerializer(CORPUS), JaxSerializer(CORPUS)
    batches = [batch_case(case, seed) for seed in (0, 1)]
    got = bytes(ser.wrap([ser.serialize_batch(p, s) for p, s in batches]))
    ref = bytes(ser.wrap([ser.serialize_batch_ref(p, s) for p, s in batches]))
    want = bytes(jser.wrap([jser.serialize_batch(p, s) for p, s in batches]))
    assert got == ref == want
    rows = pickle.loads(got)
    assert len(rows) == 12 and rows[2] == [] and rows[8] == []
    p, s = batches[0]
    first = [(int(a), float(b), CORPUS[a]) for a, b in zip(p[0], s[0]) if a >= 0]
    assert [(a, repr(b), t) for a, b, t in rows[0]] == [(a, repr(b), t) for a, b, t in first]


def test_payload_of_no_questions():
    ser = TripleSerializer(CORPUS)
    empty = np.zeros((0, 4), np.int32)
    body = ser.serialize_batch(empty, empty.astype(np.float32))
    assert body.dtype == np.uint8 and body.size == 0
    assert pickle.loads(bytes(ser.wrap([body]))) == []


@pytest.mark.parametrize("pid", [len(CORPUS), 1 << 30])
@pytest.mark.parametrize("path", ["serialize_batch", "serialize_batch_ref"])
def test_pid_out_of_range_raises_index_error(pid, path):
    ser = TripleSerializer(CORPUS)
    pids, scores = batch_case("fp32")
    pids[4, 3] = pid
    with pytest.raises(IndexError, match=f"pid {pid} out of range for {len(CORPUS)} passages"):
        getattr(ser, path)(pids, scores)


class FakeSearcher:
    """The searcher's serving contract (``tok.encode_queries``,
    ``search_tokens_device`` -> ``(scores, pids)``) over fixed rows: question
    ``"q<i>"`` gets row ``i % 11`` of ``batch_case``'s arrays."""

    def __init__(self, case):
        self.pids, self.scores = batch_case(case, nq=11, k=7)
        self.tok = SimpleNamespace(encode_queries=lambda qs: SimpleNamespace(
            input_ids=[int(q[1:]) % 11 if q else -1 for q in qs], attention_mask=None, active_mask=None))

    def search_tokens_device(self, ids, attn, active, topk=None, nprobe=None, depth=None):
        rows = np.asarray(ids)
        pids = np.where(rows[:, None] >= 0, self.pids[rows], -1).astype(np.int32)
        return self.scores[rows], pids


@pytest.mark.parametrize("case", ["fp32 special", "fp64"])
def test_pickled_payload_loads_as_retrieve_rows(case):
    cfg = ColbertConfig()
    cfg.serve.query_batch_size, cfg.serve.pipeline_inflight = 4, 2
    service = RetrievalService(FakeSearcher(case), CORPUS, cfg)
    questions = [f"q{i}" for i in range(10)]  # 3 batches, the last padded
    before = native.pickle_triples.calls.value
    payload = service.retrieve_pickled(questions, topk=7)
    assert native.pickle_triples.calls.value - before == 3
    assert isinstance(payload, np.ndarray) and payload.dtype == np.uint8
    rows, want = pickle.loads(payload), service.retrieve(questions, topk=7)
    as_repr = lambda rs: [[(p, repr(s), t) for p, s, t in r] for r in rs]  # NaN == NaN
    assert len(rows) == 10 and as_repr(rows) == as_repr(want)


def test_concurrent_serializers_share_the_blob():
    """Threads serializing different batches over one serializer each get
    their own bytes (the C++ writes only into its own output)."""
    ser = TripleSerializer(CORPUS)
    batches = [batch_case("fp32 special", seed, nq=32, k=20) for seed in range(16)]
    want = [ser.serialize_batch_ref(p, s) for p, s in batches]
    bad, interval = [], sys.getswitchinterval()

    def work(i):
        for r in range(30):
            j = (i + r) % len(batches)
            if bytes(ser.serialize_batch(*batches[j])) != want[j]:
                bad.append(j)

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not bad


def pack_case(name, dtype):
    rng = np.random.default_rng(7)
    K, n = {"lists": (13, 900), "n=0": (5, 0), "one list": (1, 300)}[name]
    assign = rng.integers(0, K, size=n).astype(np.int32)
    if name == "lists":
        assign[np.isin(assign, (0, 4, 12))] = 5  # empty lists first, inside and last
    info = np.iinfo(dtype)
    codes = rng.integers(info.min, info.max + 1, size=(n, 16)).astype(dtype)
    return assign, codes, K


@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
@pytest.mark.parametrize("name", ["lists", "n=0", "one list"])
def test_ivf_pack_matches_plain(name, dtype):
    assign, codes, K = pack_case(name, dtype)
    before = native.ivf_pack.calls.value
    perm, offsets, packed = pivf.ivf_pack(assign, codes, K)
    assert native.ivf_pack.calls.value == before + 1
    rperm, roff, rpacked = pivf.ivf_pack_ref(assign, codes, K)
    for got, want in ((perm, rperm), (offsets, roff), (packed, rpacked)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(perm, np.argsort(assign, kind="stable"))
    np.testing.assert_array_equal(np.diff(offsets), np.bincount(assign, minlength=K))
    assert packed.dtype == dtype


@pytest.mark.parametrize("bad", [-1, 13, 1 << 31])
def test_ivf_pack_refuses_a_list_out_of_range(bad):
    assign, codes, K = pack_case("lists", np.int8)
    assign = assign.astype(np.int64)
    assign[17] = bad
    with pytest.raises(ValueError):
        pivf.ivf_pack(assign, codes, K)


def assign_case(name):
    rng = np.random.default_rng(11)
    K, n, kc = 17, 1200, 4
    cand = np.stack([rng.permutation(K)[:kc] for _ in range(n)]).astype(np.int32)
    if name == "invalid candidates":
        cand[rng.random(cand.shape) < 0.2] = -1
        cand[rng.random(cand.shape) < 0.1] = K + 3
        cand[::97] = -1  # rows with no valid candidate spill
    elif name == "spills":
        cand[::3, :] = [0, 1, 2, 3]  # a third of the points want the same four lists
    elif name == "ties":
        cand[:] = [0, 1, 2, 3]  # every list past 3 stays empty until the spill fills them in turn
    cap = {"ties": 20}.get(name, int(np.ceil(n / K * 1.2)))
    return cand, K, cap


@pytest.mark.parametrize("name", ["invalid candidates", "spills", "ties"])
def test_balanced_assign_matches_plain(name):
    cand, K, cap = assign_case(name)
    before = native.balanced_assign.calls.value
    got = pivf.balanced_assign(cand, K, cap)
    assert native.balanced_assign.calls.value == before + 1
    want = pivf.balanced_assign_ref(cand, K, cap)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_failed_build_raises_with_stderr(tmp_path, monkeypatch):
    fake = tmp_path / "fake-gxx"
    fake.write_text('#!/bin/sh\nif [ "$1" = "--version" ]; then echo "fake-g++ 0.0"; exit 0; fi\n'
                    'echo "native.cpp:1: error: refused by the fake compiler" >&2\nexit 1\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_gxx", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="refused by the fake compiler"):
        _build.load_host_library("native")
    assert not list((tmp_path / "build").glob("*"))  # no library, no temporary left


def test_two_processes_build_one_library(tmp_path):
    build = tmp_path / "build"
    code = ("import sys; from pathlib import Path; from colbert_tpu_torch.ops import _build; "
            f"_build.BUILD_DIR = Path({str(build)!r}); lib = _build.load_host_library('native'); "
            "print(lib._name)")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    built = sorted(build.iterdir())
    assert len(built) == 1 and built[0].suffix == ".so"
    assert {out.strip() for out, _ in outs} == {str(built[0])}
