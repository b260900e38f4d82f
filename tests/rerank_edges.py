"""Candidate sets at the edges of the rerank's pid-window schedule, shared by
the CPU walk (``test_torch_rerank.py``) and the card tests
(``test_torch_kernels.py``).  Imports no jax."""

import numpy as np

EDGES = ["duplicate pids", "all -1 row", "one doc for all", "all distinct", "C = 77", "empty windows"]


def edge_cand(kind, rng, num_docs, B, C):
    """Candidates (B, C) int32 for one edge of the pid-window schedule (the
    caller makes C 77 for "C = 77" and num_docs >= B * C for "all distinct";
    "empty windows" leaves every window between the first and the last 7
    docs empty)."""
    cand = rng.integers(0, num_docs, size=(B, C)).astype(np.int32)
    cand[rng.random((B, C)) < 0.2] = -1
    if kind == "duplicate pids":
        cand[0, : C // 2] = cand[0, C // 2 : 2 * (C // 2)]   # every pid of row 0 twice
        cand[1, :10] = 3
    elif kind == "all -1 row":
        cand[1] = -1
    elif kind == "one doc for all":
        cand[:, rng.integers(0, C, size=B)] = -1
        cand[np.arange(B), rng.integers(0, C, size=B)] = num_docs - 1
        cand[:, 0] = num_docs - 1
    elif kind == "all distinct":
        cand = rng.permutation(num_docs)[: B * C].reshape(B, C).astype(np.int32)
    elif kind == "empty windows":   # pids only in the first and last windows of 7 docs
        lo_hi = np.concatenate([np.arange(7), np.arange(num_docs - 7, num_docs)])
        cand = rng.choice(lo_hi, size=(B, C)).astype(np.int32)
        cand[0, ::3] = -1
    return cand
