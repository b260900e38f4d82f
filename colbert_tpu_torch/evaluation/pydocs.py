"""Real-text retrieval corpus from Python docstrings: the port's copy of
``colbert_tpu/evaluation/pydocs.py`` (plain Python and numpy).

With no network and no pretrained checkpoint, the one large real
natural-language corpus available offline is the docstrings of the Python
standard library and the installed packages.

Task construction (title->body, the standard summary-retrieval shape):

* passage  = the docstring body WITHOUT its summary line (so retrieval is
  not an exact-prefix lookup) prefixed by the dotted object name;
* query    = the docstring's first (summary) line;
* positive = the object's own body;
* hard negatives = other docstrings from the SAME module (lexically and
  topically close: the analogue of mined hard negatives), topped up with
  high token-overlap passages from other modules.

This plays the reference's data pipeline role (DuReader TSV corpus + mined
hard negatives, ``proj_utils/dureader_utils.py:7-48``) with a corpus that
can be regenerated offline.  The corpus depends on the installed packages:
:func:`collect_docstrings` skips a package that fails to import (its
default list names ``jax``, which a machine may lack), as the JAX copy does.
"""

from __future__ import annotations

import importlib
import inspect
import pkgutil
import sys
import warnings
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# modules that execute code, exit, block, or print on import
_SKIP_PREFIXES = (
    "antigravity", "this", "idlelib", "turtledemo", "tkinter", "turtle",
    "lib2to3", "test", "distutils", "crypt", "pty", "tty", "curses",
    "multiprocessing.popen", "asyncio.__main__", "__main__", "pip._vendor",
    "pydoc_data", "ensurepip", "venv", "ctypes.test", "wsgiref.demo",
)


def _iter_module_names(packages: Sequence[str]) -> Iterable[str]:
    for name in sorted(sys.stdlib_module_names):
        yield name
    for pkg in packages:
        try:
            mod = importlib.import_module(pkg)
        except Exception:
            continue
        yield pkg
        if hasattr(mod, "__path__"):
            for info in pkgutil.walk_packages(mod.__path__, prefix=pkg + "."):
                yield info.name


def _clean(doc: str) -> str:
    lines = [ln.rstrip() for ln in inspect.cleandoc(doc).splitlines()]
    return "\n".join(lines).strip()


@dataclass
class DocEntry:
    name: str      # dotted object name
    module: str
    summary: str   # first docstring line
    body: str      # the rest (passage text)


def collect_docstrings(
    packages: Sequence[str] = ("numpy", "jax", "scipy", "pandas", "torch", "sklearn"),
    min_body_chars: int = 120,
    min_summary_chars: int = 20,
    max_modules: Optional[int] = None,
    max_entries: Optional[int] = None,
) -> List[DocEntry]:
    """Harvest (summary, body) docstring pairs from importable modules."""
    entries: List[DocEntry] = []
    seen_docs: set = set()
    n_mod = 0
    for name in _iter_module_names(packages):
        if name.startswith("_") or any(
            name == p or name.startswith(p + ".") for p in _SKIP_PREFIXES
        ):
            continue
        if max_modules is not None and n_mod >= max_modules:
            break
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                mod = importlib.import_module(name)
            except BaseException:
                continue
        n_mod += 1
        objs: List[Tuple[str, object]] = [(name, mod)]
        try:
            members = inspect.getmembers(mod)
        except Exception:
            members = []
        for attr, obj in members:
            if attr.startswith("_"):
                continue
            if inspect.isclass(obj) or inspect.isfunction(obj) or inspect.isbuiltin(obj):
                if getattr(obj, "__module__", None) not in (name, None):
                    continue  # skip re-exports: one entry per object
                objs.append((f"{name}.{attr}", obj))
                if inspect.isclass(obj):
                    for m_attr, m_obj in vars(obj).items():
                        if m_attr.startswith("_") or not callable(m_obj):
                            continue
                        objs.append((f"{name}.{attr}.{m_attr}", m_obj))
        for dotted, obj in objs:
            try:
                doc = inspect.getdoc(obj)
            except Exception:
                continue
            if not doc:
                continue
            doc = _clean(doc)
            nl = doc.find("\n")
            if nl < 0:
                continue
            summary, body = doc[:nl].strip(), doc[nl + 1 :].strip()
            if len(body) < min_body_chars or len(summary) < min_summary_chars:
                continue
            if not summary[0].isalpha():
                continue
            key = hash(body[:400])
            if key in seen_docs:
                continue
            seen_docs.add(key)
            entries.append(DocEntry(dotted, name, summary, body))
            if max_entries is not None and len(entries) >= max_entries:
                return entries
    return entries


def _token_set(text: str, limit: int = 64) -> set:
    return set(text.lower().split()[:limit])


def build_retrieval_dataset(
    entries: Sequence[DocEntry],
    num_negatives: int = 20,
    seed: int = 0,
    passage_max_chars: int = 1200,
) -> Tuple[List[str], List[Dict]]:
    """Corpus texts + examples in the trainer's JSON schema.

    Hard negatives: same-module passages first (topically close), then the
    highest summary-token-overlap passages from other modules, then random.
    """
    rng = np.random.default_rng(seed)
    texts = [f"{e.name}: {e.body[:passage_max_chars]}" for e in entries]
    by_module: Dict[str, List[int]] = {}
    for i, e in enumerate(entries):
        by_module.setdefault(e.module, []).append(i)

    # crude lexical index for overlap mining: token -> passage ids (capped)
    tok2ids: Dict[str, List[int]] = {}
    tsets = [_token_set(t) for t in texts]
    for i, ts in enumerate(tsets):
        for t in ts:
            ids = tok2ids.setdefault(t, [])
            if len(ids) < 200:
                ids.append(i)

    examples = []
    for i, e in enumerate(entries):
        negs: List[int] = [j for j in by_module.get(e.module, []) if j != i][: num_negatives]
        if len(negs) < num_negatives:
            qtoks = _token_set(e.summary)
            counts: Dict[int, int] = {}
            for t in qtoks:
                for j in tok2ids.get(t, ()):
                    if j != i:
                        counts[j] = counts.get(j, 0) + 1
            ranked = sorted(counts, key=lambda j: -counts[j])
            for j in ranked:
                if j not in negs:
                    negs.append(j)
                if len(negs) >= num_negatives:
                    break
        while len(negs) < num_negatives:
            j = int(rng.integers(len(entries)))
            if j != i and j not in negs:
                negs.append(j)
        examples.append(
            {
                "question": e.summary,
                "positive_ctxs": [texts[i]],
                "hard_negative_ctxs": [texts[j] for j in negs],
            }
        )
    return texts, examples


def train_dev_split(examples: List[Dict], dev_frac: float = 0.05, seed: int = 0):
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(examples))
    n_dev = max(1, int(len(examples) * dev_frac))
    dev = [examples[i] for i in order[:n_dev]]
    train = [examples[i] for i in order[n_dev:]]
    return train, dev
