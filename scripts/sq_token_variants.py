#!/usr/bin/env python3
"""Time the token-major sq probe's K10 routes on one NVIDIA GPU.

    python3 scripts/sq_token_variants.py

On a seeded input of the serving shape (2,304 tokens x 128 windows of
CSR codes, sq_dim 64, cap 463, window lengths drawn uniformly from 0 to
190, ~94 rows a window as in the bench corpus's token probe, top-512),
times with CUDA events (20 launches after 3 warm-ups):

* route "fused" as the wrapper launches it (up to 25,343 keys a token in
  shared memory, two blocks an SM);
* route "fused" with the keys' room of a whole block (54,000 keys, one
  block an SM);
* route "fused" keeping no keys (every pass scores the rows again);
* timed: route "fused" built with clock64() counters (one more nvcc, into
  ``.runs/sq_token_variants/``), thread 0 of each block adding the cycles
  it spends in each phase (window prefix sums; scoring with the top
  digit's histogram; the further radix passes; taking the survivors;
  the sort; the output), printed as the share of a block's cycles;
* route "staged": K10 alone, and K10 + ``_window_topk``.

Every route "fused" variant must be bit-equal to route "staged" +
``_window_topk``.  Prints the card's name and power limit and one line a
variant.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PROF = ("if (threadIdx.x == 0) { const long long tn = clock64(); "
        "atomicAdd(&g_prof[%d], (unsigned long long)(tn - tp)); tp = tn; }")
PHASES = ("prefix sums", "scoring", "radix passes", "survivors", "sort", "output")
TIMED = [
    ("namespace {\n", "__device__ unsigned long long g_prof[8];\nnamespace {\n"),
    ("  const int64_t t = blockIdx.x;\n  const int tid = threadIdx.x;\n",
     "  const int64_t t = blockIdx.x;\n  const int tid = threadIdx.x;\n  long long tp = clock64();\n"),
    ("  const TokenRows<D> rows{", PROF % 0 + "\n  const TokenRows<D> rows{"),
    ("  const int take = min(depth, n);\n", PROF % 1 + "\n  const int take = min(depth, n);\n"),
    ("    // 3. take the keys above the prefix", PROF % 2 + "\n    // 3. take the keys above the prefix"),
    ("  // 4. sort the survivors, best first\n", "  __syncthreads();\n" + PROF % 3 + "\n"),
    ("  // 5. write scores and CSR rows", PROF % 4 + "\n  // 5. write scores and CSR rows"),
    ("      orow[r] = -1;\n    }\n  }\n}\n", "      orow[r] = -1;\n    }\n  }\n  __syncthreads();\n" + PROF % 5 + "\n}\n"),
    ('}  // extern "C"', 'int sq_prof_read(void* out) { return int(cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof))); }\n'
     'int sq_prof_reset() { unsigned long long z[8] = {0}; return int(cudaMemcpyToSymbol(g_prof, z, sizeof(z))); }\n'
     '}  // extern "C"'),
]


def build_timed() -> ctypes.CDLL:
    from colbert_tpu_torch.ops import _build

    src = (_build.CSRC / "sq_token_scan.cu").read_text()
    for old, new in TIMED:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found once in sq_token_scan.cu: {old!r}")
        src = src.replace(old, new)
    out = ROOT / ".runs" / "sq_token_variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / "timed.cu").write_text(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(out / "timed.so"), str(out / "timed.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    for line in _build.build_logs.get("sq_token_scan", "").splitlines():  # the library as it is
        if "sq_window_topk" in line or "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    lib = ctypes.CDLL(str(out / "timed.so"))
    lib.sq_window_topk_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.sq_window_topk_launch.restype = ctypes.c_int
    lib.sq_window_topk_keys_room.argtypes = [ctypes.c_int] * 2
    lib.sq_window_topk_keys_room.restype = ctypes.c_int
    lib.sq_prof_read.argtypes, lib.sq_prof_read.restype = [ctypes.c_void_p], ctypes.c_int
    lib.sq_prof_reset.argtypes, lib.sq_prof_reset.restype = [], ctypes.c_int
    return lib


def main() -> int:
    import numpy as np
    import torch

    from colbert_tpu_torch.ops import sq_probe

    if not torch.cuda.is_available():
        print("sq_token_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    T, nprobe, cap, D, N, depth = 2304, 128, 463, 64, 320_000, 512
    to = lambda a: torch.from_numpy(a).to(dev)
    codes = to(rng.integers(-127, 128, size=(N, D)).astype(np.int8))
    starts = to(rng.integers(0, N - cap, size=(T, nprobe)).astype(np.int32))
    lens = to(rng.integers(0, 191, size=(T, nprobe)).astype(np.int32))
    qs = to((rng.normal(size=(T, D)) / (127.0 * np.sqrt(D))).astype(np.float32))

    def time_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    want = sq_probe.sq_window_topk(starts, lens, qs, codes, cap=cap, depth=depth, route="staged")

    def check(name, got, ms):
        same = torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)) and torch.equal(got[1], want[1])
        print(f"{name}: {ms:.4f} ms, {'bit-equal to' if same else 'DIFFERS from'} route staged")
        return same

    rows = int(lens.sum())
    print(f"{T} tokens x {nprobe} windows, cap {cap}, depth {depth}: {rows} real rows, "
          f"{rows / T:.0f} a token (max {int(lens.sum(dim=1).max())})")
    ok = True
    for name, keys_cap in (("fused (wrapper), two blocks an SM", None), ("fused, 54,000 keys, one block an SM", 54_000),
                           ("fused, no keys kept", 0)):
        fn = lambda: sq_probe._launch_fused(starts, lens, qs, codes, cap, depth, keys_cap)
        ok &= check(name, fn(), time_ms(fn))

    lib = build_timed()
    keys_cap = min(nprobe * cap, lib.sq_window_topk_keys_room(nprobe, depth))
    out_s = torch.empty((T, depth), dtype=torch.float32, device=dev)
    out_r = torch.empty((T, depth), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def timed():
        err = lib.sq_window_topk_launch(starts.data_ptr(), lens.data_ptr(), qs.data_ptr(), codes.data_ptr(),
                                        out_s.data_ptr(), out_r.data_ptr(), T, nprobe, cap, depth, keys_cap, D,
                                        stream)
        if err:
            raise RuntimeError(f"timed launch failed: cudaError_t {err}")
        return out_s, out_r

    ms = time_ms(timed)
    torch.cuda.synchronize()
    lib.sq_prof_reset()
    timed()
    torch.cuda.synchronize()
    prof = (ctypes.c_ulonglong * 8)()
    lib.sq_prof_read(ctypes.byref(prof))
    total = sum(prof[: len(PHASES)])
    ok &= check("timed", (out_s, out_r), ms)
    print(f"timed: {total / T:.0f} cycles a block (thread 0), by phase: "
          + ", ".join(f"{ph} {prof[i] / total:.3f}" for i, ph in enumerate(PHASES)))

    print(f"staged, K10 alone: {time_ms(lambda: sq_probe._launch(starts, lens, qs, codes, cap)):.4f} ms")
    staged = lambda: sq_probe.sq_window_topk(starts, lens, qs, codes, cap=cap, depth=depth, route="staged")
    print(f"staged, K10 + _window_topk: {time_ms(staged):.4f} ms")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
