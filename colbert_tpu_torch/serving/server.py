"""Retrieval serving: in-process service + socket server/client + evaluator.

Counterpart of ``colbert_tpu/serving/server.py`` with the same protocol
(the reference's ``dense_server_client.py:21-78``): requests are
``(questions, topk, candidate_depth, nprobe)`` tuples over a
``multiprocessing.connection`` socket; responses are per-question lists of
``(pid, score, paragraph_text)`` triples, or ``{"error": ...}``.

Batches within a request are pipelined: batch i+1 is tokenized and
dispatched while the device still runs batch i
(:meth:`ColbertSearcher.search_tokens_device`); connections are served on a
thread each.
"""

from __future__ import annotations

import socket
import threading
import traceback
from collections import deque
from multiprocessing.connection import Client as MPClient, Listener
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from colbert_tpu_torch.config import ColbertConfig
from colbert_tpu_torch.evaluation.metrics import eval_retrieval
from colbert_tpu_torch.utils.logging import get_logger
from colbert_tpu_torch.ranking.searcher import ColbertSearcher
from colbert_tpu_torch.serving.serializer import TripleSerializer

logger = get_logger("serving")

Triple = Tuple[int, float, str]


class RetrievalService:
    """Batched retrieval over a searcher + in-RAM passage texts."""

    def __init__(self, searcher: ColbertSearcher, corpus: Sequence[str],
                 cfg: Optional[ColbertConfig] = None):
        self.searcher = searcher
        self.corpus = corpus
        self.cfg = cfg or searcher.cfg
        self._serializer: Optional[TripleSerializer] = None  # built on first retrieve_pickled
        self._ser_lock = threading.Lock()

    def _rows(self, pids, scores, n_real) -> List[List[Triple]]:
        pl = pids[:n_real].tolist()
        sl = scores[:n_real].tolist()
        corpus = self.corpus
        return [
            [(p, s, corpus[p]) for p, s in zip(prow, srow) if p >= 0]
            for prow, srow in zip(pl, sl)
        ]

    def _retrieve_batches(self, questions: Sequence[str], topk: Optional[int],
                          depth: Optional[int], nprobe: Optional[int], consume) -> None:
        """Pipelined batch loop: up to ``serve.pipeline_inflight`` batches in
        flight.  The tail batch is padded with empty questions to the static
        batch size.  ``consume(pids, scores, n_real)`` runs per drained
        batch, in order."""
        s = self.cfg.serve
        topk = topk or s.topk
        bs = s.query_batch_size
        inflight = max(1, s.pipeline_inflight)
        pending: deque = deque()

        def drain_one():
            n_real, handle = pending.popleft()
            ts, tp = handle
            consume(np.asarray(tp), np.asarray(ts), n_real)

        for lo in range(0, len(questions), bs):
            chunk = list(questions[lo : lo + bs])
            n_real = len(chunk)
            chunk = chunk + [""] * (bs - n_real)
            enc = self.searcher.tok.encode_queries(chunk)
            handle = self.searcher.search_tokens_device(
                enc.input_ids, enc.attention_mask, enc.active_mask,
                topk=topk, nprobe=nprobe, depth=depth,
            )
            pending.append((n_real, handle))
            if len(pending) >= inflight:
                drain_one()
        while pending:
            drain_one()

    def retrieve(self, questions: Sequence[str], topk: Optional[int] = None,
                 depth: Optional[int] = None, nprobe: Optional[int] = None) -> List[List[Triple]]:
        out: List[List[Triple]] = []
        self._retrieve_batches(
            questions, topk, depth, nprobe,
            lambda pids, scores, n_real: out.extend(self._rows(pids, scores, n_real)),
        )
        return out

    def retrieve_pickled(self, questions: Sequence[str], topk: Optional[int] = None,
                         depth: Optional[int] = None, nprobe: Optional[int] = None) -> np.ndarray:
        """Same result as :meth:`retrieve`, already serialized as the pickle
        payload ``conn.recv()`` expects (a uint8 array: a bytes-like that
        ``conn.send_bytes`` takes as it is)."""
        with self._ser_lock:
            if self._serializer is None:
                self._serializer = TripleSerializer(self.corpus)
        ser = self._serializer
        chunks: List[np.ndarray] = []
        self._retrieve_batches(
            questions, topk, depth, nprobe,
            lambda pids, scores, n_real: chunks.append(
                ser.serialize_batch(pids[:n_real], scores[:n_real])
            ),
        )
        return ser.wrap(chunks)


class RetrievalServer:
    def __init__(self, service: RetrievalService, host: Optional[str] = None,
                 port: Optional[int] = None, authkey: Optional[bytes] = None):
        s = service.cfg.serve
        self.service = service
        # port 0 binds a free port; ``address`` then holds it once ``ready`` is set
        self.address = (host or s.host, s.port if port is None else port)
        self.authkey = authkey or s.authkey.encode()
        self.ready = threading.Event()
        self._stop = threading.Event()
        self._listener: Optional[Listener] = None

    def _handle_conn(self, conn) -> None:
        """Per-connection request loop, on its own thread."""
        try:
            while True:
                try:
                    req = conn.recv()
                except (EOFError, OSError):
                    break
                if req == "__shutdown__":
                    self._stop.set()
                    conn.send({"ok": True})
                    self.stop()  # close the listener: unblocks accept()
                    break
                try:
                    questions, topk, depth, nprobe = req
                    payload = self.service.retrieve_pickled(
                        questions, topk=topk, depth=depth, nprobe=nprobe
                    )
                    conn.send_bytes(payload)
                except Exception as e:  # noqa: BLE001 -- report, don't die
                    logger.error("retrieval error: %s", traceback.format_exc())
                    conn.send({"error": f"{type(e).__name__}: {e}"})
        finally:
            conn.close()

    def serve_forever(self) -> None:
        self._listener = Listener(self.address, authkey=self.authkey)
        self.address = self._listener.address
        self.ready.set()
        logger.info("retrieval server listening on %s", self.address)
        from multiprocessing import AuthenticationError

        while not self._stop.is_set():
            try:
                conn = self._listener.accept()
            except AuthenticationError:
                # a client with a bad authkey must not take the server down
                logger.warning("rejected connection: bad authkey")
                continue
            except (EOFError, ConnectionError):
                # nor one that drops during the handshake (stop() wakes the
                # loop this way too)
                continue
            except OSError:
                break  # the listener was closed
            threading.Thread(target=self._handle_conn, args=(conn,), daemon=True).start()
        try:
            self._listener.close()
        except OSError:
            pass

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def stop(self) -> None:
        """Stop accepting connections and shut the searcher's host-rerank
        worker down."""
        self._stop.set()
        self.service.searcher.close()
        if self._listener is not None:
            # closing a listening socket does not wake a thread blocked in
            # accept(): connect once so serve_forever sees the stop flag
            try:
                socket.create_connection(self.address, timeout=1.0).close()
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass


class RetrievalClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 9090, authkey: bytes = b"colbert-tpu"):
        self.address = (host, port)
        self.authkey = authkey

    def retrieve(self, questions: Sequence[str], topk: int = 100, depth: int = 512,
                 nprobe: int = 128) -> List[List[Triple]]:
        with MPClient(self.address, authkey=self.authkey) as conn:
            conn.send((list(questions), topk, depth, nprobe))
            res = conn.recv()
        if isinstance(res, dict) and "error" in res:
            raise RuntimeError(res["error"])
        return res

    def shutdown(self) -> None:
        with MPClient(self.address, authkey=self.authkey) as conn:
            conn.send("__shutdown__")
            conn.recv()


def evaluate_retrieval(
    retrieve_fn,
    eval_data: Sequence[Dict[str, Any]],
    topk: int = 100,
    batch: int = 1024,
    recall_topk: Sequence[int] = (50, 100),
) -> Dict[str, float]:
    """End-to-end evaluation: retrieve in batches, attach ``res``, compute
    MRR@10 / recall@k (``colbert_tpu.evaluation.metrics.eval_retrieval``)."""
    out = []
    for lo in range(0, len(eval_data), batch):
        chunk = list(eval_data[lo : lo + batch])
        res = retrieve_fn([t["question"] for t in chunk], topk)
        for t, r in zip(chunk, res):
            out.append({**t, "res": r})
    return eval_retrieval(out, topk=10, recall_topk=recall_topk)
