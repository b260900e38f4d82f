#!/usr/bin/env python3
"""The socket request latency and the index build's host spans, from any checkout, on one NVIDIA GPU.

    python3 scripts/host_runtime_latency.py [--root CHECKOUT] [--requests N]

Imports ``chip_smoke`` and ``colbert_tpu_torch`` from ``--root`` (this
checkout by default) and encodes phase 2's corpus (20,000 synthetic Chinese
passages, a seeded random BERT-base).  Then, through the CLI: flat
``serve`` over the socket, ``--requests`` requests of 144 questions and two
of 1,024 (phase 2's questions cycled) at top-100, each timed on the host
clock; ``build-index`` at phase 5c's sq operating point with
``index.balance_factor=1.2`` (the build's ``balanced_assign`` and
``csr_pack`` spans from its ``meta.json``); ANN ``serve`` over the socket,
``--requests`` requests of 144.  Answers are compared across runs by a
digest of their pids.  Prints the card's name and power limit and one JSON
line.  Two checkouts compare in one call, in turns (parent, change, change,
parent), each in a process of its own.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import tempfile
import threading
import time
from pathlib import Path


def serve_and_time(cs, cfg, args, corpus_path, batches, tag):
    """``serve`` in a thread, one warm-up, then each request of ``batches``
    (question lists, with the ANN arguments) timed; returns the times in ms
    and a digest of the answers' pids."""
    from colbert_tpu_torch import cli
    from colbert_tpu_torch.serving.server import RetrievalClient

    err = []

    def serve():
        try:
            cli.main(["serve", "--corpus", str(corpus_path), *args])
        except BaseException as e:  # noqa: BLE001 -- reported by the main thread
            err.append(e)

    server = threading.Thread(target=serve, daemon=True, name=f"serve-{tag}")
    server.start()
    cs.wait_for_server(cfg, err)
    client = RetrievalClient(cfg.serve.host, cfg.serve.port, cfg.serve.authkey.encode())
    s = cfg.serve
    client.retrieve(batches[0][0][:1], topk=cs.TOPK, depth=s.candidate_depth, nprobe=s.nprobe)  # warm-up
    times, digest = {}, hashlib.sha256()
    for name, qs in batches:
        t0 = time.perf_counter()
        ans = client.retrieve(qs, topk=cs.TOPK, depth=s.candidate_depth, nprobe=s.nprobe)
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        digest.update(json.dumps([[p for p, _, _ in row] for row in ans]).encode())
    client.shutdown()
    server.join(timeout=60)
    if server.is_alive() or err:
        raise RuntimeError(f"{tag} server did not stop cleanly: {err}")
    for name, ms in times.items():
        cs.log(f"[{tag}] {name}: " + " / ".join(f"{t:.1f}" for t in ms) + f" ms, median {statistics.median(ms):.1f}")
    return {name: {"ms": ms, "median_ms": statistics.median(ms)} for name, ms in times.items()}, digest.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the checkout whose chip_smoke.py and colbert_tpu_torch run")
    ap.add_argument("--requests", type=int, default=5, help="requests of 144 questions a path")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import chip_smoke as cs
    from colbert_tpu_torch import cli
    from colbert_tpu_torch.utils.io import load_json

    if not torch.cuda.is_available():
        print("host_runtime_latency: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    label = cs.card_label()
    cs.log(f"{label}; checkout {args.root}")
    out = {"root": args.root}
    with tempfile.TemporaryDirectory(prefix="host_runtime_latency_") as tmp:
        c = cs.encoded_corpus(device, Path(tmp), label)
        questions = c["questions"]
        big = [questions[i % len(questions)] for i in range(1024)]
        requests = [("flat 144", c["requests"][i % len(c["requests"])]) for i in range(args.requests)]
        out["flat"], out["flat_digest"] = serve_and_time(
            cs, c["cfg"], c["common"], c["corpus_path"], requests + [("flat 1024", big)] * 2, "flat")

        acfg = cs.ann_config(c["cfg"], c["cfg"].index.index_path, cs.free_port())
        acfg.index.balance_factor = 1.2
        conf = Path(tmp) / "conf_ann.yaml"
        acfg.to_yaml(conf)
        ann_args = ["--config", str(conf), *c["common"][2:]]
        t0 = time.perf_counter()
        cli.main(["build-index", *ann_args])
        out["build_s"] = time.perf_counter() - t0
        timers = load_json(Path(acfg.index.index_path) / "meta.json")["build_timers"]
        out["build_spans"] = {k: timers[k] for k in ("balanced_assign", "csr_pack") if k in timers}
        cs.log(f"[build] build-index (sq, balance_factor 1.2) {out['build_s']:.1f} s; spans {timers}")
        ann = [("ann 144", c["requests"][i % len(c["requests"])]) for i in range(args.requests)]
        out["ann"], out["ann_digest"] = serve_and_time(cs, acfg, ann_args, c["corpus_path"], ann, "ann")
    cs.log(label)
    cs.log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
