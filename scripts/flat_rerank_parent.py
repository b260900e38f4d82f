"""K1 and K4/K5 at dim 768 against another checkout's build, on the card.

Builds ``colbert_tpu_torch/csrc/flat_scan.cu`` and ``csrc/rerank.cu`` of
this checkout and of the checkout under DIR, then calls each build's C
interface (``flat_scan_launch``, ``rerank_wgmma_launch``: both keep them)
on route "wgmma" at the shapes the main path gives them at dim 768:

* K1 (fp32 stored scores and group maxima) at phase 1's shape, 144 queries
  x 16 views against 20,000 docs x 16 rows (``chip_smoke.topic_embeddings``),
  over the bf16 table and its int8 quantization;
* K4 (bf16) and K5 (int8, the three-term query) over the same tables on
  a serving batch of 144 queries x 4,096 candidates (each query 4,096
  distinct docs drawn at random, one in ten -1), its pid-window schedule
  made once by this checkout's ``ops/rerank.py``.

Every output of the two builds must be bit-equal.  Each launch is timed on
the card as ``chip_smoke.time_ms`` times it (CUDA events, 20 launches after
3), the builds in turns (this, the parent, the parent, this) ``--rounds``
times; the medians of each build's runs are kept.  Writes
``chiprun_out/flat_rerank_parent.json`` and prints the card's name and
power limit; exits 1 if an output differs.

    mkdir -p .runs/parent && git archive HEAD colbert_tpu_torch/csrc | tar -x -C .runs/parent
    python3 scripts/flat_rerank_parent.py .runs/parent [--rounds 3]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

NUM_DOCS, C = 20_000, 4096


def build(csrc: Path, out: Path):
    """The flat scan's and the rerank's libraries of the sources under ``csrc``, with argtypes."""
    from colbert_tpu_torch.ops import _build

    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
                                     str(csrc / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True) for name in ("flat_scan", "rerank")}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {csrc / name}.cu:\n{err}")
    flat = ctypes.CDLL(str(out / "flat_scan.so")).flat_scan_launch
    flat.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + \
        [ctypes.c_int] * 9 + [ctypes.c_void_p]
    rerank = ctypes.CDLL(str(out / "rerank.so")).rerank_wgmma_launch
    rerank.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    flat.restype = rerank.restype = ctypes.c_int
    return flat, rerank


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from chip_smoke import B, H, M
    from colbert_tpu_torch.ops import flat_scan as fs, rerank as rr

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, help="a checkout (or its colbert_tpu_torch/csrc alone) to compare with")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flat_rerank_parent: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    label = chip_smoke.card_label()
    print(label, flush=True)
    csrc = args.parent / "colbert_tpu_torch" / "csrc"
    builds = {"this": build(ROOT / "colbert_tpu_torch" / "csrc", ROOT / "chiprun_out" / "build_this"),
              "parent": build(csrc if csrc.exists() else args.parent, ROOT / "chiprun_out" / "build_parent")}
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    docs, queries = chip_smoke.topic_embeddings(NUM_DOCS, 16, B, M, H, seed=chip_smoke.SEED)
    Qm = torch.from_numpy(queries).to(dev)
    rng = np.random.default_rng(7)
    cand = np.stack([rng.permutation(NUM_DOCS)[:C] for _ in range(B)]).astype(np.int32)
    cand[rng.random(cand.shape) < 0.1] = -1
    cand = torch.from_numpy(cand).to(dev)
    cases = {}
    for dtype in ("bfloat16", "int8"):
        table, inv, dv = fs.build_flat_table(docs, np.full(NUM_DOCS, 16), dtype=dtype)
        table = table.to(dev)
        Q = Qm * inv.to(dev) if inv is not None else Qm
        int8 = dtype == "int8"
        # K1: the wrapper's operands (ops/flat_scan.py::_launch), fp32 stored scores
        q, docs_pad, group = fs.query_operand(Q), table.shape[0] // 16, fs.group_docs(16)

        def k1(fn, q=q, table=table, docs_pad=docs_pad, group=group, int8=int8):
            scores = torch.empty((docs_pad, B), dtype=torch.float32, device=dev)
            gmax = torch.full((-(-docs_pad // group), B), float("-inf"), dtype=torch.float32, device=dev)
            err = fn(q.data_ptr(), table.data_ptr(), int(int8), scores.data_ptr(), gmax.data_ptr(), B, M, H, 16,
                     docs_pad, NUM_DOCS, group, 1, 1, stream)
            if err:
                raise RuntimeError(f"flat_scan_launch: cudaError_t {err}")
            return scores, gmax
        # K4 / K5: the wrapper's operands (ops/rerank.py::_launch), the schedule made once
        num_docs = table.shape[0] // 16
        window = rr.window_docs(num_docs, C, 16 * H * table.element_size())
        spid, perm, wstart = rr.rerank_schedule(cand, num_docs, window)
        qr = rr.query_operand(Q, int8)

        def k45(fn, qr=qr, table=table, spid=spid, perm=perm, wstart=wstart, num_docs=num_docs, int8=int8):
            out = torch.full((B, C), float("-inf"), dtype=torch.float32, device=dev)
            err = fn(qr.data_ptr(), table.data_ptr(), int(int8), spid.data_ptr(), perm.data_ptr(), wstart.data_ptr(),
                     out.data_ptr(), B, C, H, num_docs, wstart.shape[1] - 1, stream)
            if err:
                raise RuntimeError(f"rerank_wgmma_launch: cudaError_t {err}")
            return (out,)
        cases[f"K1 {dtype}"] = (k1, 0)
        cases[f"K{5 if int8 else 4} {dtype}"] = (k45, 1)
    res, ok = {}, True
    for name, (call, which) in cases.items():
        outs = {b: call(fns[which]) for b, fns in builds.items()}
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs["this"], outs["parent"]))
        ok &= same
        runs = {"this": [], "parent": []}
        for _ in range(args.rounds):
            for b in ("this", "parent", "parent", "this"):
                runs[b].append(chip_smoke.time_ms(lambda: call(builds[b][which])))
        res[name] = {"bit_equal": same, **{f"{b}_ms": statistics.median(v) for b, v in runs.items()},
                     "runs": runs}
        print(f"{name} at dim {H}: this {res[name]['this_ms']:.4f} ms, parent {res[name]['parent_ms']:.4f} ms "
              f"(medians of {2 * args.rounds}); outputs bit-equal: {same}", flush=True)
    out = ROOT / "chiprun_out" / "flat_rerank_parent.json"
    out.write_text(json.dumps({"card": label, "rounds": args.rounds, "cases": res}, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
