#!/usr/bin/env python3
"""Time variants of the sq slot scan's "mma" route (K6) on one NVIDIA GPU.

    python3 scripts/slot_scan_variants.py

Builds ``colbert_tpu_torch/csrc/sq_probe.cu`` as it is and with one line
changed (one nvcc each, in parallel, into ``.runs/slot_scan_variants/``),
and times each route-"mma" launch (the work-list kernel and the scan,
CUDA events over 50 launches) on a seeded slot schedule of the serving shape, drawn to
match the histogram chip_smoke.py's phase 5a prints for the bench corpus
(4,853 filled slots; list rows median 82, p99 200, max 463; members a slot
median 50): K 4,096 lists, 2,304 tokens x nprobe 128 with a skewed list
popularity, tpl 128 x 8 groups, r 8, sq_dim 64.  Variants:

* design: the source as it is;
* no walk: the products and the score tile, no top-r walk;
* no products: the walk over pseudo-random scores (integer hashes of the
  operands in place of each mma.sync), no tensor-core work;
* timed: the design with clock64() counters, thread 0 of each block
  adding the cycles it spends in each phase of an item (set-up and token
  staging; waiting for a stage's rows and the block; the products and the
  block; its own walk; the outputs and the block), printed as cycles a
  block beside the kernel's cycles at the card's highest SM clock.

Also times the route "staged" kernel on the same schedule.  Prints the
card's name and power limit and one line a variant: milliseconds, and the
largest score difference from the plain version (which only the variants
that keep the arithmetic hold within 1e-5).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

WALK = "if (t >= 0) topr::walk_stage<R, SC_STRIDE>(h, sc + tid, r0 - astart, n);"
MMA = "hopper::mma_bf16_16816(j ? e : d, a[ks], b.x, b.y);"
HASH = ("d[0] += float((a[ks][0] ^ b.x) & 0xffffu); d[1] += float((a[ks][1] ^ b.y) & 0xffffu); "
        "d[2] += float((a[ks][2] ^ b.x) & 0xffffu); d[3] += float((a[ks][3] ^ b.y) & 0xffffu);")
PROF = "if (tid == 0) { const long long tn = clock64(); atomicAdd(&g_prof[%d], (unsigned long long)(tn - tp)); tp = tn; }"
PHASES = ("item set-up", "rows wait", "products", "walk", "item end")
TIMED = [
    ('#include "hopper.cuh"\n', '#include "hopper.cuh"\n__device__ unsigned long long g_prof[8];\n'),
    ("if (item_sh >= count) break;  // uniform across the block",
     "if (item_sh >= count) break;\n    long long tp = clock64();"),
    ("    uint64_t h[R];", PROF % 0 + "\n    uint64_t h[R];"),
    ("__syncthreads();  // chunk c and the tokens are in; the last chunk's walk is done",
     "__syncthreads(); " + PROF % 1),
    ("__syncthreads();  // the score tile is complete", "__syncthreads(); " + PROF % 2),
    (WALK, WALK + PROF % 3),
    ("__syncthreads();  // every thread has read this item's shared state", "__syncthreads(); " + PROF % 4),
    ('}  // extern "C"', 'int sq_prof_read(void* out) { return int(cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof))); }\n'
     'int sq_prof_reset() { unsigned long long z[8] = {0}; return int(cudaMemcpyToSymbol(g_prof, z, sizeof(z))); }\n'
     'int sq_mma_blocks_per_sm() { int n = 0; cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, '
     'slot_scan_mma_kernel<64, 8>, THREADS, MmaSmem<64, 1>::TOTAL); return n; }\n}  // extern "C"'),
]
VARIANTS = {
    "design": [],
    "no walk": [(WALK, ";")],
    "no products": [(MMA, HASH)],
    "timed": TIMED,
}
K, T, NPROBE, TPL, GROUPS, R, D = 4096, 2304, 128, 128, 8, 8, 64


def build(out: Path):
    from colbert_tpu_torch.ops import _build

    src = (ROOT / "colbert_tpu_torch/csrc/sq_probe.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    for header in (ROOT / "colbert_tpu_torch/csrc").glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        s = src
        for a, b in edits:
            if a not in s:
                raise SystemExit(f"variant {name!r}: {a!r} is not in sq_probe.cu")
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
        lib.sq_slot_scan_mma_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.sq_slot_scan_mma_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def schedule(dev):
    """A seeded slot schedule and CSR codes of the serving shape."""
    import numpy as np
    import torch

    from colbert_tpu_torch.ops import sq_probe_batched as sp

    rng = np.random.default_rng(0)
    pop = rng.normal(size=K)                                   # list popularity
    lens = np.clip(np.rint(78 * np.exp(0.05 * pop + 0.45 * rng.normal(size=K))), 0, 463).astype(np.int64)
    lens[np.argmax(pop)] = 463                                 # the corpus's longest list, probed most
    offsets = np.zeros(K + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    codes = torch.from_numpy(rng.integers(-127, 128, size=(int(offsets[-1]), D)).astype(np.int8)).to(dev)
    coarse = torch.from_numpy(rng.normal(size=(T, K)) + 0.9 * pop).float().to(dev)
    vals, lists = torch.topk(coarse, NPROBE, dim=1)
    sched, _ = sp.build_slot_schedule_dense(coarse >= vals[:, -1:], lists, tpl=TPL, groups=GROUPS)
    qs = torch.from_numpy(rng.normal(size=(T, D)) / (127.0 * np.sqrt(D))).float().to(dev)
    return sched.qidx, torch.from_numpy(offsets).to(dev), qs, codes


def main() -> int:
    import torch

    from colbert_tpu_torch.ops import sq_probe_batched as sp

    if not torch.cuda.is_available():
        print("slot_scan_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(ROOT / ".runs" / "slot_scan_variants")
    dev = torch.device("cuda")
    qidx, offsets, qs, codes = schedule(dev)
    S = qidx.shape[0]
    filled = qidx[:, 0] >= 0
    rows = torch.diff(offsets).long()[torch.nonzero(filled).flatten() % K].double()
    members = (qidx[filled] >= 0).sum(dim=1).double()
    print(f"schedule: {int(filled.sum())} of {S} slots filled; list rows median {float(rows.median()):.0f}, "
          f"p99 {float(torch.quantile(rows, 0.99)):.0f}, max {int(rows.max())}; members median "
          f"{float(members.median()):.0f}, p99 {float(torch.quantile(members, 0.99)):.0f}", flush=True)
    work = torch.empty(S + 1, dtype=torch.int32, device=dev)
    out_s = torch.empty((S, R, TPL), device=dev)
    out_r = torch.empty((S, R, TPL), dtype=torch.int32, device=dev)
    want = sp.sq_batch_list_scan_ref(qidx, offsets, qs, codes, r=R)[0][filled]

    def run(lib):
        err = lib.sq_slot_scan_mma_launch(qidx.data_ptr(), work.data_ptr(), offsets.data_ptr(), qs.data_ptr(),
                                          codes.data_ptr(), out_s.data_ptr(), out_r.data_ptr(),
                                          S, K, D, TPL, R, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")

    def ms(fn, iters=50):
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
    for name, lib in libs.items():
        t = ms(lambda: run(lib))
        got = out_s[filled]
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max()) if torch.equal(fin, torch.isfinite(got)) else float("inf")
        print(f"{name:14s} {t:.4f} ms  max|d| {err:.1e}", flush=True)
    lib = libs["timed"]
    for fn in (lib.sq_prof_read, lib.sq_prof_reset, lib.sq_mma_blocks_per_sm):
        fn.restype = ctypes.c_int
    lib.sq_prof_read.argtypes = [ctypes.c_void_p]
    lib.sq_prof_reset()
    run(lib)
    torch.cuda.synchronize()
    prof = (ctypes.c_ulonglong * 8)()
    lib.sq_prof_read(ctypes.addressof(prof))
    per_sm = lib.sq_mma_blocks_per_sm()
    grid = min(S, per_sm * torch.cuda.get_device_properties(0).multi_processor_count)
    clock = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True).stdout.split()[0]) * 1e6
    print(f"timed: {per_sm} blocks an SM, grid {grid}; cycles a block by phase: "
          + ", ".join(f"{p} {prof[i] / grid:.0f}" for i, p in enumerate(PHASES))
          + f"; the kernel {ms(lambda: run(lib)) * 1e-3 * clock:.0f} cycles at {clock / 1e6:.0f} MHz")
    staged = lambda: sp._launch(qidx, offsets, qs, codes, R, hot=False, route="staged")
    print(f"{'route staged':14s} {ms(staged):.4f} ms (wrapper)")
    print(f"{'work list':14s} {ms(lambda: sp.work_list_kernel(qidx, offsets)):.4f} ms (its kernel alone)")
    print(f"{'route mma':14s} {ms(lambda: sp.sq_batch_list_scan(qidx, offsets, qs, codes, r=R)):.4f} ms (wrapper)")
    print(label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
