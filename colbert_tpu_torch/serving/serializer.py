"""Pickle-stream response serializer for the retrieval server.

A copy of ``colbert_tpu/serving/serializer.py``'s pure-Python path
(``colbert_tpu.serving``'s package ``__init__`` imports jax, and the port
never calls ``colbert_tpu.native``).  Every passage text is pre-encoded once
as a pickle fragment (``'X' + len + utf8 + TUPLE3``); a response is those
fragments joined with each triple's pid and score, so
``conn.send_bytes(payload)`` delivers bytes that a stock ``conn.recv()``
client unpickles as the per-question lists of ``(pid, score, text)``.
"""

from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np

# protocol-2 pickle: PROTO 2, EMPTY_LIST, MARK ... APPENDS, STOP
_HEADER = b"\x80\x02]("
_FOOTER = b"e."


class TripleSerializer:
    """Pre-encoded corpus text fragments + per-batch response assembly."""

    def __init__(self, corpus: Sequence[str]):
        parts: List[bytes] = []
        off = np.empty(len(corpus) + 1, np.int64)
        off[0] = 0
        w = 0
        for i, t in enumerate(corpus):
            b = t.encode("utf-8")
            # BINUNICODE + TUPLE3: pushes the text, closes the triple
            parts.append(b"X" + struct.pack("<I", len(b)) + b + b"\x87")
            w += 6 + len(b)
            off[i + 1] = w
        self._blob_bytes = b"".join(parts)
        self.off = off
        self.num_pids = len(corpus)

    def serialize_batch(self, pids: np.ndarray, scores: np.ndarray) -> bytes:
        """Pickle body for one batch of response rows: ``(nq, k)`` pids
        (-1 padded) + scores -> the per-question ``](...)e`` byte runs."""
        blob, off = self._blob_bytes, self.off
        out: List[bytes] = []
        for prow, srow in zip(np.asarray(pids).tolist(), np.asarray(scores).tolist()):
            out.append(b"](")
            for p, s in zip(prow, srow):
                if p >= 0:
                    if p >= self.num_pids:
                        raise IndexError(f"pid {p} out of range for {self.num_pids} passages")
                    out.append(
                        b"J" + struct.pack("<i", p) + b"G" + struct.pack(">d", s)
                        + blob[off[p] : off[p + 1]]
                    )
            out.append(b"e")
        return b"".join(out)

    @staticmethod
    def wrap(batch_chunks: Sequence[bytes]) -> bytes:
        """Complete pickle payload from per-batch bodies."""
        return b"".join([_HEADER, *batch_chunks, _FOOTER])
