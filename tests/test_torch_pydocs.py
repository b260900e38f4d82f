"""The port's real-text corpus (``evaluation/pydocs.py``) and learned
WordPiece vocab (``tokenization/vocab.py::train_wordpiece``) against the JAX
package's, on the CPU.  Both are plain Python and numpy copies, so each
output must equal JAX's exactly: entries field for field, examples and
splits as lists, the vocab list for list.  The collection is bounded
(``max_modules``, the standard library only) to a few seconds.
"""

import dataclasses

import pytest

from colbert_tpu.evaluation import pydocs as jpd
from colbert_tpu.tokenization import vocab as jvocab
from colbert_tpu_torch.evaluation import pydocs as tpd
from colbert_tpu_torch.tokenization import vocab as tvocab


@pytest.fixture(scope="module")
def entries():
    """The first 25 importable standard-library modules' docstrings, collected
    by each package (JAX's first, so both see the same imported modules)."""
    want = jpd.collect_docstrings(packages=(), max_modules=25)
    got = tpd.collect_docstrings(packages=(), max_modules=25)
    return want, got


def test_collect_docstrings_matches_jax(entries):
    want, got = entries
    assert len(got) == len(want) > 20
    assert [dataclasses.astuple(e) for e in got] == [dataclasses.astuple(e) for e in want]
    assert all(isinstance(e, tpd.DocEntry) for e in got)
    # max_entries stops the collection at that many
    capped = tpd.collect_docstrings(packages=(), max_modules=25, max_entries=7)
    assert [dataclasses.astuple(e) for e in capped] == [dataclasses.astuple(e) for e in want[:7]]


def test_collect_docstrings_skips_packages_that_do_not_import():
    """A listed package that fails to import is skipped, as the JAX copy skips
    it (the default list names jax, which a machine may lack)."""
    names = list(tpd._iter_module_names(("no_such_package_here", "json")))
    assert "no_such_package_here" not in names and "json" in names
    assert names == list(jpd._iter_module_names(("no_such_package_here", "json")))


@pytest.mark.parametrize("num_negatives,seed", [(5, 0), (20, 3)])
def test_build_retrieval_dataset_and_split_match_jax(entries, num_negatives, seed):
    want, got = entries
    wt, wx = jpd.build_retrieval_dataset(want, num_negatives=num_negatives, seed=seed)
    gt, gx = tpd.build_retrieval_dataset(got, num_negatives=num_negatives, seed=seed)
    assert gt == wt and gx == wx
    assert all(len(x["hard_negative_ctxs"]) == num_negatives for x in gx)
    for frac in (0.05, 0.3):
        assert tpd.train_dev_split(gx, dev_frac=frac, seed=seed) == jpd.train_dev_split(wx, dev_frac=frac, seed=seed)


@pytest.mark.parametrize("vocab_size,min_count,max_merges", [(400, 2, None), (150, 1, 40), (90, 2, None)])
def test_train_wordpiece_matches_jax(entries, vocab_size, min_count, max_merges):
    """The learned vocab equals JAX's list for list, on the docstring corpus."""
    want, _ = entries
    texts, examples = jpd.build_retrieval_dataset(want, num_negatives=3)
    corpus = texts + [x["question"] for x in examples]
    got = tvocab.train_wordpiece(corpus, vocab_size=vocab_size, min_count=min_count, max_merges=max_merges)
    assert got == jvocab.train_wordpiece(corpus, vocab_size=vocab_size, min_count=min_count, max_merges=max_merges)
    assert len(got) <= vocab_size and len(set(got)) == len(got) and got[: len(tvocab.SPECIALS)] == tvocab.SPECIALS


def test_exports_match_jax():
    import colbert_tpu.tokenization as jtok
    import colbert_tpu_torch.evaluation as tev
    import colbert_tpu_torch.tokenization as ttok

    assert "train_wordpiece" in jtok.__all__ and ttok.train_wordpiece is tvocab.train_wordpiece
    for name in ("collect_docstrings", "build_retrieval_dataset", "train_dev_split", "DocEntry"):
        assert getattr(tev, name) is getattr(tpd, name)
