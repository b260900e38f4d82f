#!/usr/bin/env python3
"""Time variants of the rerank's "wgmma" route (K4/K5) on one NVIDIA GPU.

    python3 scripts/rerank_variants.py [--dim 312]

Builds ``colbert_tpu_torch/csrc/rerank.cu`` as it is and with one constant or
line changed (one nvcc each, in parallel, into ``.runs/rerank_variants/``),
and times each kernel's wrapper path (schedule, query operand, launch) with
CUDA events on random inputs of the serving shape: 144 queries x 4,096
candidates (2,615 distinct pids a query, the rest -1) over 20,000 docs x 16
rows x 768 (``--dim``; bf16 unit rows; int8 uniform in +-127, at a dim of
whole 64-dim chunks alone), and the same candidates spread over 200,000
docs (p -> 10p + b mod 10) with the windows the port picks and with
512-doc windows.  Variants:

* design: the source as it is;
* one producer: one thread issues every TMA box (PROD = 1);
* 64-dim boxes: one 128-byte column chunk a box (3x the boxes for bf16,
  2x for int8, the same bytes);
* hot docs, no products: every group loads docs 0..7 (always in L2) and
  issues no wgmma -- what the box stream alone costs (its scores are wrong);
* producer copies: the bf16 doc boxes copied by the producer warps at
  every dim (cp.async, as at a dim that is not whole 64-dim chunks, where
  no tensor map describes the last chunk), not by the 3-D tensor map.

Prints the card's name and power limit and one line per variant and case:
milliseconds, and the largest difference from the plain version (which
only the variants that keep the arithmetic must hold within 1e-4).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MMA = """              wgmma_rs(d, a[st], sw128_desc(q0 + (k / 64) * K::q_chunk + ((k % 64) / 16) * 32), k != 0);"""
HOT = "pid[d] = d < nd ? row[g0 + d] : 0;"
VARIANTS = {
    "design": [],
    "one producer": [("constexpr int PROD = 4;", "constexpr int PROD = 1;")],
    "64-dim boxes": [("static constexpr int chunks = I8 ? 2 : 3;", "static constexpr int chunks = 1;"),
                     ("static constexpr int stages = I8 ? 4 : 3;", "static constexpr int stages = 8;")],
    "hot docs, no products": [(HOT, "pid[d] = d;"), (MMA, "              ;")],
    "producer copies": [(": dim % 64 ? launch_wgmma<false, true>", ": dim > 0 ? launch_wgmma<false, true>")],
}
B, C, N = 144, 4096, 20_000


def build(out: Path):
    from colbert_tpu_torch.ops import _build

    src = (ROOT / "colbert_tpu_torch/csrc/rerank.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    (out / "hopper.cuh").write_text((ROOT / "colbert_tpu_torch/csrc/hopper.cuh").read_text())
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        s = src
        for a, b in edits:
            if a not in s:
                raise SystemExit(f"variant {name!r}: {a!r} is not in rerank.cu")
            s = s.replace(a, b)
        (out / f"v{i}.cu").write_text(s)
        procs[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"v{i}.so"),
                                        str(out / f"v{i}.cu")], stderr=subprocess.PIPE, text=True)
    libs = {}
    for i, (name, p) in enumerate(procs.items()):
        _, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name!r}:\n{err}")
        lib = ctypes.CDLL(str(out / f"v{i}.so"))
        lib.rerank_wgmma_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 4
                                            + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.rerank_wgmma_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import argparse

    import numpy as np
    import torch

    from colbert_tpu_torch.ops import rerank as rr

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=768, help="the table's width (default 768, the serving point's)")
    H = ap.parse_args().dim
    if not torch.cuda.is_available():
        print("rerank_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(ROOT / ".runs" / "rerank_variants")
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)

    def tables(n):
        x = torch.randn(n * 16, H, device=dev, generator=g)
        t = (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        del x
        return t, torch.randint(-127, 128, (n * 16, H), dtype=torch.int8, device=dev, generator=g)

    rng = np.random.default_rng(0)
    cand = np.full((B, C), -1, np.int32)
    for b in range(B):
        cand[b, :2615] = rng.choice(N, 2615, replace=False)
        rng.shuffle(cand[b])
    cand = torch.from_numpy(cand).to(dev)
    cand_low = torch.where(cand >= 0, cand * 10 + (torch.arange(B, device=dev, dtype=torch.int32) % 10)[:, None], cand)
    Q = torch.randn(B, 16, H, device=dev, generator=g)
    Q = Q / Q.norm(dim=-1, keepdim=True)

    def run(lib, c, tab, q, window):
        num_docs = tab.shape[0] // 16
        int8 = tab.dtype == torch.int8
        spid, perm, wstart = rr.rerank_schedule(c, num_docs, window)
        qo = rr.query_operand(q, int8)
        out = torch.full((B, C), float("-inf"), device=dev)
        err = lib.rerank_wgmma_launch(qo.data_ptr(), tab.data_ptr(), int(int8), spid.data_ptr(), perm.data_ptr(),
                                      wstart.data_ptr(), out.data_ptr(), B, C, H, num_docs, wstart.shape[1] - 1,
                                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return out

    def ms(fn, iters=30):
        for _ in range(3):
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
    for case, c, n in (("20k docs", cand, N), ("200k docs", cand_low, 10 * N)):
        t16, t8 = tables(n)
        for kname, tab, q, ref in (("K4", t16, Q, rr.maxsim_rerank_uniform_ref),
                                   ("K5", t8, Q / 127.0, rr.maxsim_rerank_uniform_int8_ref))[: 1 + (H % 64 == 0)]:
            want = ref(c, q, tab, dv=16)
            live = c >= 0
            port_window = rr.window_docs(n, C, 16 * H * tab.element_size())
            for window in sorted({port_window, 512}):
                for name, lib in libs.items():
                    err = float((run(lib, c, tab, q, window) - want)[live].abs().max())
                    t = ms(lambda: run(lib, c, tab, q, window))
                    print(f"{case:9s} {kname} window {window:5d}{' (port)' if window == port_window else '       '} "
                          f"{name:22s} {t:.3f} ms  max|d| {err:.1e}", flush=True)
        del t16, t8
    print(label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
