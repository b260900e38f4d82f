#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``colbert_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the flat-scan CUDA kernel from ``colbert_tpu_torch/csrc`` and drives
the port's exact flat serving path once, at full BERT-base width, with
random weights from a seed:

* phase 1: kernels K1 (fused scan + group max) and K2 (full score matrix)
  against their plain PyTorch versions on the card, at B=144 queries x 16
  views x 768 dims: 20,000 docs x 16 rows (bf16 table, fp32 and bf16
  stored scores; int8 table), and 1,001 docs x 37 rows (a ragged last
  group).  Limits: fp32 scores within 1e-4; bf16 stored scores within one
  bf16 ulp of the value (a last-bit fp32 difference can flip the rounding),
  or within the fp32 limit near zero, where the fp32 summation-order error
  (~3e-5 at these widths) exceeds a bf16 ulp.
* phase 2: the CLI's ``encode`` over a 20,000-doc synthetic Chinese corpus,
  ``serve`` in a background thread, three requests of 144 questions at
  top-100 through ``RetrievalClient``, ``evaluate --remote``, and the same
  requests through the unfused route (``serve.flat_fused_topk=false``).
  Every answer must hold 100 valid, descending triples whose scores equal
  the plain version's top-100 over the same table and query encodings
  within 1e-4 (tie-insensitive), and each kernel must have launched in
  the run: K1 once per served batch.

Prints the card's name and power limit, the measurements, one JSON line of
kernels, and last ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result line, when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

SEED = 1234
B, M, H = 144, 16, 768
TOPK = 100
SCORE_ATOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---- seeded inputs ----

def topic_embeddings(num_docs, d_view, num_queries, q_view, dim, seed=0, n_topics=256):
    """Clustered, anisotropic unit vectors (``bench.py``'s synthetic corpus),
    plus queries drawn around the same topics.  Returns fp16 doc rows
    (num_docs * d_view, dim) and fp32 queries (num_queries, q_view, dim)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    spectrum = (1.0 / np.sqrt(1.0 + np.arange(dim))).astype(np.float32)
    topics = rng.normal(size=(n_topics, dim)).astype(np.float32) * spectrum
    topics /= np.linalg.norm(topics, axis=1, keepdims=True)

    def draw(n, views):
        t = rng.integers(0, n_topics, size=n)
        e = topics[np.repeat(t, views)] + 0.3 * (
            rng.normal(size=(n * views, dim)).astype(np.float32) * spectrum
        )
        e /= np.linalg.norm(e, axis=1, keepdims=True)
        return e

    docs = draw(num_docs, d_view).astype(np.float16)
    queries = draw(num_queries, q_view).reshape(num_queries, q_view, dim)
    return docs, queries


def synthetic_chinese(num_docs, num_questions, seed=0, n_topics=64):
    """Topic-structured Chinese passages and questions (a question is drawn
    from its positive passage's topic words)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    chars = np.array([chr(c) for c in range(0x4E00, 0x4E00 + 3000)])
    topic_words = [rng.choice(chars, size=40, replace=False) for _ in range(n_topics)]
    puncts = list("，。！？；、")
    doc_topic = rng.integers(0, n_topics, size=num_docs)
    docs = []
    for t in doc_topic:
        n = int(rng.integers(40, 120))
        body = np.where(rng.random(n) < 0.6, rng.choice(topic_words[t], size=n), rng.choice(chars, size=n))
        for j in rng.integers(0, n, size=n // 15):
            body[j] = puncts[int(rng.integers(len(puncts)))]
        docs.append("".join(body) + "。")
    positives = rng.integers(0, num_docs, size=num_questions)
    questions = [
        "".join(rng.choice(topic_words[doc_topic[p]], size=int(rng.integers(6, 14)))) + "？"
        for p in positives
    ]
    return docs, questions, positives


# ---- phase 1: kernels against their plain versions ----

def bf16_limit(*xs):
    """One bf16 ulp (8 significant bits) at the larger magnitude of ``xs``,
    and never below the fp32 limit: two fp32 scores within ``SCORE_ATOL``
    round to bf16 values at most ``SCORE_ATOL + ulp`` apart."""
    import torch

    ax = torch.stack([x.float().abs() for x in xs]).amax(dim=0)
    _, e = torch.frexp(ax.clamp_min(torch.finfo(torch.float32).tiny))
    return torch.ldexp(torch.ones_like(ax), e - 8).clamp_min(SCORE_ATOL)


def time_ms(fn, iters=20, warmup=3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernels(device, num_docs=20_000, ragged_docs=1_001, seed=SEED):
    """Compare K1/K2 with their plain versions; returns per-kernel summaries."""
    import numpy as np
    import torch

    from colbert_tpu_torch.ops import flat_scan as fs

    docs, queries = topic_embeddings(num_docs, 16, B, M, H, seed=seed)
    Qm = torch.from_numpy(queries).to(device)
    doclens = np.full(num_docs, 16)
    worst = {"K1": 0.0, "K2": 0.0}

    def check(name, got, want, atol):
        got, want = got.float(), want.float()
        fin = torch.isfinite(want)
        if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(got[~fin], want[~fin]):
            raise AssertionError(f"{name}: -inf pattern differs from the plain version")
        err = (got[fin] - want[fin]).abs()
        lim = atol if not torch.is_tensor(atol) else atol[fin]
        over = err > lim
        bad = int(over.sum())
        log(f"[phase1] {name}: max|d|={float(err.max()):.3e} over {err.numel()} values, {bad} beyond limit")
        if bad:
            pairs = torch.stack([got[fin][over], want[fin][over]], dim=1)[:5].tolist()
            raise AssertionError(f"{name}: {bad} values beyond the limit, e.g. (got, want) {pairs}")
        return float(err.max())

    def run_case(label, table, q, dv, n_docs):
        k2 = fs.flat_maxsim_scan(q, table, dv=dv)
        k2_ref = fs.flat_maxsim_scan_ref(q, table, dv=dv)
        worst["K2"] = max(worst["K2"], check(f"{label} K2 scores fp32", k2, k2_ref, SCORE_ATOL))
        s, g = fs.flat_scan_fused(q, table, dv=dv, num_docs=n_docs, score_dtype="float32")
        rs, rg = fs.flat_scan_fused_ref(q, table, dv=dv, num_docs=n_docs, score_dtype="float32")
        e1 = check(f"{label} K1 stored fp32", s, rs, SCORE_ATOL)
        e1 = max(e1, check(f"{label} K1 group max", g, rg, SCORE_ATOL))
        ts, tp = fs.select_topk(s, g, group=fs.group_docs(dv), num_docs=n_docs, topk=TOPK)
        want_s, _ = torch.topk(k2_ref[:n_docs].T, min(TOPK, n_docs), dim=1)
        e1 = max(e1, check(f"{label} K1 top-{TOPK} scores", ts, want_s, SCORE_ATOL))
        if not ((tp >= 0) & (tp < n_docs)).all():
            raise AssertionError(f"{label}: top-k returned a pad doc")
        worst["K1"] = max(worst["K1"], e1)

    table, _, dv = fs.build_flat_table(docs, doclens, dtype="bfloat16")
    table = table.to(device)
    run_case(f"{num_docs} docs bf16", table, Qm, dv, num_docs)
    s, g = fs.flat_scan_fused(Qm, table, dv=dv, num_docs=num_docs, score_dtype="bfloat16")
    rs, rg = fs.flat_scan_fused_ref(Qm, table, dv=dv, num_docs=num_docs, score_dtype="bfloat16")
    check(f"{num_docs} docs K1 stored bf16 (1 ulp, >= 1e-4)", s, rs, bf16_limit(s, rs))
    check(f"{num_docs} docs K1 group max bf16 (1 ulp, >= 1e-4)", g, rg, bf16_limit(g, rg))

    times = {
        "K1": (time_ms(lambda: fs.flat_scan_fused(Qm, table, dv=dv, num_docs=num_docs, score_dtype="float32")),
               time_ms(lambda: fs.flat_scan_fused_ref(Qm, table, dv=dv, num_docs=num_docs, score_dtype="float32"), iters=5)),
        "K2": (time_ms(lambda: fs.flat_maxsim_scan(Qm, table, dv=dv)),
               time_ms(lambda: fs.flat_maxsim_scan_ref(Qm, table, dv=dv), iters=5)),
    }
    del table

    t8, inv, dv = fs.build_flat_table(docs, doclens, dtype="int8")
    run_case(f"{num_docs} docs int8", t8.to(device), Qm * inv.to(device), dv, num_docs)
    del t8

    rdocs, rq = topic_embeddings(ragged_docs, 37, B, M, H, seed=seed + 1)
    tr, _, dv = fs.build_flat_table(rdocs, np.full(ragged_docs, 37), dtype="bfloat16")
    if (tr.shape[0] // dv) % fs.group_docs(dv) == 0:
        raise AssertionError("ragged case does not end inside a group")
    run_case(f"{ragged_docs} docs dv=37", tr.to(device), torch.from_numpy(rq).to(device), dv, ragged_docs)
    for k, (ms, plain) in times.items():
        log(f"[phase1] {k} at {num_docs} docs x 16 rows bf16, B={B}: kernel {ms:.3f} ms, plain {plain:.3f} ms")
    return worst, times


# ---- phase 2: the slice through the CLI ----

def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_slice(device, workdir: Path, label: str, num_docs=20_000, model_kw=None,
                tok_kw=None, n_requests=3, seed=SEED):
    import numpy as np
    import torch

    from colbert_tpu.config import ColbertConfig, IndexConfig, ModelConfig, ServeConfig, TokenizerConfig
    from colbert_tpu.tokenization.vocab import build_vocab, write_vocab
    from colbert_tpu.utils.io import dump_json
    from colbert_tpu_torch import cli
    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.models.convert import reference_state_dict
    from colbert_tpu_torch.ops import flat_scan as fs
    from colbert_tpu_torch.ranking.searcher import ColbertSearcher
    from colbert_tpu_torch.serving.server import RetrievalClient, RetrievalService

    n_eval = 2 * B
    docs, questions, positives = synthetic_chinese(num_docs, n_requests * B + n_eval, seed=seed)
    corpus_path, eval_path = workdir / "corpus.json", workdir / "eval.json"
    dump_json(docs, corpus_path)
    eval_q = questions[n_requests * B :]
    dump_json([{"question": q, "positive_ctxs": [docs[p]]}
               for q, p in zip(eval_q, positives[n_requests * B :])], eval_path)
    model_cfg = ModelConfig(**(model_kw or {}))
    vocab_path = write_vocab(build_vocab(docs + questions, max_size=model_cfg.vocab_size),
                             workdir / "vocab.txt")

    cfg = ColbertConfig(
        model=model_cfg,
        tokenizer=TokenizerConfig(vocab_path=str(vocab_path), **(tok_kw or {})),
        index=IndexConfig(index_path=str(workdir / "index"), num_parts=4),
        serve=ServeConfig(mode="flat", topk=TOPK, query_batch_size=B, port=free_port()),
    )
    conf_path = workdir / "conf.yaml"
    cfg.to_yaml(conf_path)
    model = ColbertModel(cfg.model, cfg.multiview)
    model.init_weights(torch.Generator().manual_seed(seed))
    bin_path = workdir / "pytorch.bin"
    torch.save(reference_state_dict(model.state_dict(), cfg.model), bin_path)
    log(f"[phase2] model hidden={cfg.model.hidden_size} layers={cfg.model.num_layers} "
        f"heads={cfg.model.num_heads} ffn={cfg.model.intermediate_size} vocab={cfg.model.vocab_size} "
        f"dim={cfg.model.dim} {cfg.model.dtype}; vocab file {len(open(vocab_path, encoding='utf-8').read().split())} tokens")
    common = ["--config", str(conf_path), "--pretrain", str(bin_path), "--device", str(device)]

    t0 = time.perf_counter()
    cli.main(["encode", "--corpus", str(corpus_path), *common])
    if device.type == "cuda":
        torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    log(f"[phase2] encode: {num_docs} docs in {enc_s:.2f} s = {num_docs / enc_s:.1f} docs/s "
        f"(doc_maxlen {cfg.tokenizer.doc_maxlen}, host tokenization included) [{label}]")

    serve_err = []

    def serve():
        try:
            cli.main(["serve", "--corpus", str(corpus_path), *common])
        except BaseException as e:  # noqa: BLE001 -- reported by the main thread
            serve_err.append(e)

    server = threading.Thread(target=serve, daemon=True, name="serve")
    server.start()
    client = RetrievalClient(cfg.serve.host, cfg.serve.port, cfg.serve.authkey.encode())
    from multiprocessing.connection import Client

    deadline = time.time() + 600
    while True:
        if serve_err:
            raise RuntimeError(f"serve failed: {serve_err[0]!r}")
        try:
            Client((cfg.serve.host, cfg.serve.port), authkey=cfg.serve.authkey.encode()).close()
            break
        except ConnectionRefusedError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)

    # the oracle side: the same table and model, the unfused (K2) route
    cfg_k2 = ColbertConfig.from_dict(cfg.to_dict())
    cfg_k2.serve.flat_fused_topk = False
    oracle_model = ColbertModel(cfg.model, cfg.multiview)
    oracle_model.load_state_dict(model.state_dict())
    k2_searcher = ColbertSearcher(cfg_k2, cli._tokenizer(cfg), oracle_model,
                                  IndexStorage(cfg.index.index_path), device=device)
    k2_service = RetrievalService(k2_searcher, docs, cfg_k2)
    requests = [questions[i * B : (i + 1) * B] for i in range(n_requests)]
    k2_service.retrieve(requests[0][:1], topk=TOPK)  # warm-up outside the counted run

    # ---- the counted main-path run ----
    fs.flat_scan_fused.launches.reset()
    fs.flat_maxsim_scan.launches.reset()
    answers, lat = [], []
    for qs in requests:
        t0 = time.perf_counter()
        answers.append(client.retrieve(qs, topk=TOPK))
        lat.append(time.perf_counter() - t0)
    cli.main(["evaluate", "--eval-data", str(eval_path), "--remote", "--topk", str(TOPK), *common])
    k2_answers = [k2_service.retrieve(qs, topk=TOPK) for qs in requests]
    launches = {"K1": fs.flat_scan_fused.launches.value, "K2": fs.flat_maxsim_scan.launches.value}
    # ----

    client.shutdown()
    server.join(timeout=60)
    if server.is_alive() or serve_err:
        raise RuntimeError(f"server did not stop cleanly: {serve_err}")
    for i, dt in enumerate(lat):
        log(f"[phase2] request {i}: {B} questions top-{TOPK} in {dt * 1e3:.1f} ms = {B / dt:.1f} QPS "
            f"over the socket (first request includes warm-up) [{label}]")
    served_batches = n_requests + -(-n_eval // B)
    log(f"[phase2] launches in the main-path run: {launches} (K1 expected {served_batches}, "
        f"K2 expected {n_requests})")
    if launches["K1"] != served_batches or launches["K2"] != n_requests:
        raise AssertionError(f"kernel launches {launches} do not match the served batches")

    # ---- answers against the plain version on the same table and encodings ----
    worst, recall = 0.0, []
    table, dv = k2_searcher.emb_table, k2_searcher.flat_dv
    for qs, ans_sets in zip(requests, zip(answers, k2_answers)):
        enc = k2_searcher.tok.encode_queries(qs)
        Qm = k2_searcher.encode_queries(enc.input_ids, enc.attention_mask, enc.active_mask)
        full = fs.flat_maxsim_scan_ref(Qm, table, dv=dv)[:num_docs].T    # (B, num_docs)
        want_s, want_p = torch.topk(full, TOPK, dim=1)
        full, want_s, want_p = full.cpu().numpy(), want_s.cpu().numpy(), want_p.cpu().numpy()
        for ans in ans_sets:
            if len(ans) != len(qs):
                raise AssertionError(f"{len(ans)} answers for {len(qs)} questions")
            for b, row in enumerate(ans):
                pids = np.array([p for p, _, _ in row])
                scores = np.array([s for _, s, _ in row], np.float32)
                if len(row) != TOPK or not ((pids >= 0) & (pids < num_docs)).all():
                    raise AssertionError(f"question {b}: {len(row)} triples or invalid pids")
                if any(t != docs[p] for p, _, t in row):
                    raise AssertionError(f"question {b}: a triple's text is not its passage")
                if (np.diff(scores) > 0).any():
                    raise AssertionError(f"question {b}: scores not descending")
                err = max(np.abs(scores - want_s[b]).max(), np.abs(scores - full[b, pids]).max())
                worst = max(worst, float(err))
                recall.append(len(set(pids.tolist()) & set(want_p[b].tolist())) / TOPK)
    log(f"[phase2] served top-{TOPK} scores vs the plain version: max|d|={worst:.3e} "
        f"(limit {SCORE_ATOL}); pid recall@{TOPK} {np.mean(recall):.4f} (information only: "
        f"random-init views are near ties)")
    if worst > SCORE_ATOL:
        raise AssertionError(f"served scores differ from the plain version by {worst}")
    return launches, worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from colbert_tpu_torch.ops import _build, flat_scan as fs

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    label = card_label()
    log(label)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    fs._kernel_lib()
    log(f"[build] flat_scan.cu built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_logs.get("flat_scan", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    worst, times = phase_kernels(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches, _ = phase_slice(device, Path(tmp), label)

    kernels = []
    for name, fn, line in (("K1 flat_scan_fused", "K1", 157), ("K2 flat_maxsim_scan", "K2", 59)):
        kernels.append({
            "name": name, "route": "cuda", "source": "colbert_tpu_torch/csrc/flat_scan.cu",
            "replaces": f"colbert_tpu/ops/flat_scan.py:{line}", "launches": launches[fn],
            "max_abs_err": worst[fn], "ms": times[fn][0], "plain_ms": times[fn][1],
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
