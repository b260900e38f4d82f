#!/usr/bin/env python3
"""Time variants of the rerank's "wgmma_rows" route (K4/K5) on one NVIDIA GPU.

    python3 scripts/rerank_rows_variants.py [--quick]

Builds ``colbert_tpu_torch/csrc/rerank.cu`` as it is and with one constant or
line changed (one nvcc each, in parallel, into ``.runs/rerank_rows_variants/``),
and times the route's wrapper path (schedule, work list, query operand,
launch) with CUDA events, each variant in turns with the design, on random
inputs of ``chip_smoke.py`` phase 9a's shapes: 144 queries x 4,096 distinct
candidates of 10,000 docs of 40-124 rows, cut into the percentile stride
buckets (bf16 unit rows for K4, int8 uniform in +-127 for K5), 32 query
rows; and K5 over 144 x 256 host blocks of 124 rows (every pair its own
doc).  Variants:

* design: the source as it is;
* parts of 32 / 128 (K4) and parts of 64 (K5): the most docs a work item
  holds (``Cfg::PART``: 64 for K4, 32 for K5);
* two query buffers: K4 keeps a second query buffer at the price of its
  third stage (K5's 144 KB query leaves no room for a second);
* stages at most 2: a shallower ring;
* the other split: K4's stage issued as one wgmma group after all of its
  A fragments load, K5's as two (``Cfg::SPLIT``: 2 for K4, 1 for K5);
* a k-step branch: each product under ``if (k < dim)`` (the design pads
  the query with zeros to whole stages instead);
* no products: the box stream, the A loads and the epilogue without any
  wgmma (its scores are wrong) -- what the stream alone costs.

Prints the card's name and power limit and, a line per variant and case,
milliseconds beside the design's in the same turns, and the largest
difference from the plain version (which only the variants that keep the
arithmetic must hold within 1e-4).  ``--quick``: the design and one
variant.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MMA = "wgmma_rs(d, a[st], sw128_desc(q0 + (k / 64) * K::q_chunk + ((k % 64) / 16) * 32), k != 0);"
NO_MMA = "                " + MMA
VARIANTS = {
    "design": [],
    "K4 parts of 32": [("PART = I8 ? 32 : 64;", "PART = I8 ? 32 : 32;")],
    "K4 parts of 128": [("PART = I8 ? 32 : 64;", "PART = I8 ? 32 : 128;")],
    "K5 parts of 64": [("PART = I8 ? 32 : 64;", "PART = I8 ? 64 : 64;")],
    "two query buffers": [("MAX_QBUF) * p.qsize + 3 * size_t(K::stage)", "MAX_QBUF) * p.qsize + 2 * size_t(K::stage)")],
    "stages at most 2": [("constexpr int MAX_STAGES = 4;", "constexpr int MAX_STAGES = 2;")],
    "the other split": [("SPLIT = I8 ? 1 : 2;", "SPLIT = I8 ? 2 : 1;")],
    "no products": [(NO_MMA, "                ;")],
    "a k-step branch": [("                wgmma_rs(d, a[st], sw128_desc(q0", "                if (k < dim) wgmma_rs(d, a[st], sw128_desc(q0")],
}
B, C, N, QV, H, HOST_C, CAP = 144, 4096, 10_000, 32, 768, 256, 124


def build(out: Path, names):
    from colbert_tpu_torch.ops import _build

    src = (ROOT / "colbert_tpu_torch/csrc/rerank.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    (out / "hopper.cuh").write_text((ROOT / "colbert_tpu_torch/csrc/hopper.cuh").read_text())
    procs = {}
    for i, name in enumerate(names):
        s = src
        for a, b in VARIANTS[name]:
            if s.count(a) != 1:
                raise SystemExit(f"variant {name!r}: {a!r} is not in rerank.cu once")
            s = s.replace(a, b)
        (out / f"v{i}.cu").write_text(s)
        procs[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"v{i}.so"),
                                        str(out / f"v{i}.cu")], stderr=subprocess.PIPE, text=True)
    libs, arrives = {}, {}
    for i, (name, p) in enumerate(procs.items()):
        _, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name!r}:\n{err}")
        lines = err.splitlines()
        for j, line in enumerate(lines):  # each "wgmma_rows" kernel's registers and spills
            if "C7519" in line and "rerank_rows_kernel" in line:
                arrives[name] = arrives.get(name, 0) + 1
            if "Compiling entry" in line and "rerank_rows_kernel" in line:
                kind = "int8" if "ILb1E" in line else "bf16"
                print(f"[ptxas] {name} {kind}: " + "; ".join(x.strip() for x in lines[j + 2 : j + 4]), flush=True)
        lib = ctypes.CDLL(str(out / f"v{i}.so"))
        lib.rerank_rows_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 4
                                           + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.rerank_rows_launch.restype = ctypes.c_int
        lib.rerank_rows_part.argtypes, lib.rerank_rows_part.restype = [ctypes.c_int], ctypes.c_int
        libs[name] = lib
        print(f"[ptxas] {name}: {arrives.get(name, 0)} warpgroup.arrive injected in the wgmma_rows kernels", flush=True)
    return libs


def main() -> int:
    import numpy as np
    import torch

    from colbert_tpu_torch.ops import rerank as rr

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="the design and the first variant only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rerank_rows_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    names = list(VARIANTS)[:2] if args.quick else list(VARIANTS)
    libs = build(ROOT / ".runs" / "rerank_rows_variants", names)
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    rng = np.random.default_rng(0)
    doclens = rng.integers(40, 125, size=N)
    strides = rr.stride_buckets(doclens, row_multiple=16)
    bucket_of = np.searchsorted(strides, doclens, side="left")
    slot_of = np.zeros(N, np.int64)
    for b in range(len(strides)):
        ids = np.nonzero(bucket_of == b)[0]
        slot_of[ids] = np.arange(len(ids))
    cand = np.stack([rng.permutation(N)[:C] for _ in range(B)]).astype(np.int64)
    Q = torch.randn(B, QV, H, device=dev, generator=g)
    Q = Q / Q.norm(dim=-1, keepdim=True)

    def tables(rows, int8):
        if int8:
            return torch.randint(-127, 128, (rows, H), dtype=torch.int8, device=dev, generator=g)
        x = torch.randn(rows, H, device=dev, generator=g)
        return (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)

    def run(lib, c, tab, q, dv):
        int8 = tab.dtype == torch.int8
        num_docs = tab.shape[0] // dv
        window = rr.window_docs(num_docs, c.shape[1], dv * H * tab.element_size())
        spid, perm, wstart = rr.rerank_schedule(c, num_docs, window)
        items = rr.rerank_items(wstart, c.shape[1], lib.rerank_rows_part(int(int8)))
        qo = rr.query_operand(q, int8)
        out = torch.full(c.shape, float("-inf"), device=dev)
        err = lib.rerank_rows_launch(qo.data_ptr(), tab.data_ptr(), int(int8), spid.data_ptr(), perm.data_ptr(),
                                     items.data_ptr(), out.data_ptr(), c.shape[0], c.shape[1], H, dv, num_docs,
                                     items.shape[0], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return out

    def ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    label = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    print(label, flush=True)
    cases = []
    for kname, int8 in (("K4", False), ("K5", True)):
        q = Q / 127.0 if int8 else Q
        for b, stride in enumerate(strides):
            ids = np.nonzero(bucket_of == b)[0]
            cb = torch.from_numpy(np.where(bucket_of[cand] == b, slot_of[cand], -1).astype(np.int32)).to(dev)
            cases.append((f"{kname} bucket {stride}", cb, tables(len(ids) * stride, int8), q, stride))
    host = torch.arange(B * HOST_C, dtype=torch.int32, device=dev).view(B, HOST_C)
    cases.append(("K5 host blocks", host, tables(B * HOST_C * CAP, True), Q / 127.0, CAP))
    totals = {}
    for case, c, tab, q, dv in cases:
        ref = rr.maxsim_rerank_uniform_int8_ref if tab.dtype == torch.int8 else rr.maxsim_rerank_uniform_ref
        want = ref(c, q, tab, dv=dv)
        live = c >= 0
        for name, lib in libs.items():
            err = float((run(lib, c, tab, q, dv) - want)[live].abs().max())
            turns = [ms(lambda: run(lib_, c, tab, q, dv)) for lib_ in (libs["design"], lib, lib, libs["design"])]
            t, base = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
            key = (case.split()[0] + (" host" if "host" in case else " buckets"), name)
            totals[key] = totals.get(key, 0.0) + t
            print(f"{case:16s} {name:18s} {t:8.3f} ms (design in the same turns {base:8.3f})  max|d| {err:.1e}",
                  flush=True)
        del tab
    for (what, name), t in totals.items():
        print(f"sum {what:12s} {name:18s} {t:8.3f} ms")
    print(label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
