"""Pickle-stream response serializer for the retrieval server.

Counterpart of ``colbert_tpu/serving/serializer.py``.  Every passage text is
pre-encoded once as a pickle fragment (``'X' + len + utf8 + TUPLE3``); a
response is those fragments joined with each triple's pid and score, so
``conn.send_bytes(payload)`` delivers bytes that a stock ``conn.recv()``
client unpickles as the per-question lists of ``(pid, score, text)``.  The
join runs in the port's C++ host runtime (``native.pickle_triples``, the
interpreter lock released); :meth:`TripleSerializer.serialize_batch_ref` is
the same body in Python, the plain version the tests hold it to.
"""

from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np

from colbert_tpu_torch.native import pickle_triples

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
        self.blob = np.frombuffer(self._blob_bytes, np.uint8)
        self.off = off
        self.num_pids = len(corpus)

    def serialize_batch(self, pids: np.ndarray, scores: np.ndarray) -> np.ndarray:
        """Pickle body for one batch of response rows: ``(nq, k)`` pids
        (-1 padded) + scores -> the per-question ``](...)e`` byte runs, as a
        uint8 array."""
        return pickle_triples(pids, scores, self.num_pids, self.blob, self.off)

    def serialize_batch_ref(self, pids: np.ndarray, scores: np.ndarray) -> bytes:
        """:meth:`serialize_batch` in Python: the same bytes."""
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
    def wrap(batch_chunks: Sequence) -> np.ndarray:
        """Complete pickle payload from per-batch bodies (bytes-likes), as
        one preallocated uint8 array: ``conn.send_bytes`` takes any buffer,
        so the join is the only copy."""
        total = len(_HEADER) + sum(len(c) for c in batch_chunks) + len(_FOOTER)
        out = np.empty(total, np.uint8)
        out[: len(_HEADER)] = np.frombuffer(_HEADER, np.uint8)
        pos = len(_HEADER)
        for c in batch_chunks:
            n = len(c)
            out[pos : pos + n] = np.frombuffer(c, np.uint8)
            pos += n
        out[pos:] = np.frombuffer(_FOOTER, np.uint8)
        return out
