#!/usr/bin/env python3
"""Time variants of the PQ4 list scan K8 (both routes) on one NVIDIA GPU.

    python3 scripts/pq4_scan_variants.py [--routes lookup,onehot]

Builds ``colbert_tpu_torch/csrc/pq4_scan.cu`` as it is and with a few lines
changed (one nvcc each, in parallel, into ``.runs/pq4_scan_variants/``), and
times each kernel launch (CUDA events over 20 launches) on a seeded input of
the serving shape: K 4,096 lists whose lengths match the bench corpus's
(median ~80 rows, max 463), 2,304 tokens x nprobe 128 with a skewed list
popularity, m 128 (64 code bytes a row), r 8.  Variants of route "lookup"
(the first design):

* design: the source as it is;
* no merge: each lane's own top r, no shuffle rounds merging the lanes';
* loads only: the code loads and adds, no shared-memory LUT lookups;
* no code loads: the lookups over codes made from the row's address;
* timed: the design with clock64() counters, lane 0 of each warp adding
  the cycles of its phases (the LUT staged into shared memory; scoring a
  list's rows; the merge; the output), printed as shares of the total.

Variants of route "onehot":

* design: the source as it is (the work list and the scan);
* no products: no one-hot fragments and no wgmma (the walk over zeros);
* no walk: the products and the score tiles, no top-r walk;
* staging only: neither, the producer's codes and LUT stages alone;
* products only: no LUT copies and no walk;
* timed: the design with clock64() counters around the barrier waits of
  one thread of each role (consumer, walker, producer), printed as cycles
  a block beside the kernel's cycles at the card's highest SM clock: which
  role waits on which.

Also times each route asked for through the wrapper and, with "onehot", its
work list alone.  Prints the card's name and power limit and one line a
variant: milliseconds, and the largest score difference from the plain
version (only the variants that keep the arithmetic hold it within 1e-5).
``lookup_phase_split`` gives route "lookup"'s clock64 split on other inputs
(``chip_smoke.py`` phase 6b calls it).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

K, T, NPROBE, M, R = 4096, 2304, 128, 128, 8

# ---- route "lookup" ----
LK_MERGE = "    for (int i = 0; i < r; ++i) {\n      float bs = ss[0];"
LK_LUT = ("    ae += lut[(2 * jj) * KSUB + (b & 15u)];\n    ao += lut[(2 * jj + 1) * KSUB + (b >> 4)];")
LK_LOAD = "      const uint4 q = __ldg(src + v);"
LK_PROF = ("if ((threadIdx.x & 31) == 0) { const long long tn = clock64(); "
           "atomicAdd(&g_prof[%d], (unsigned long long)(tn - tp)); tp = tn; }")
LK_PHASES = ("LUT staging", "scan", "merge", "output")
LK_TIMED = [
    ("#include \"topr.cuh\"\n", "#include \"topr.cuh\"\n__device__ unsigned long long g_prof[8];\n"),
    ("  const int64_t t = blockIdx.x;\n", "  long long tp = clock64();\n  const int64_t t = blockIdx.x;\n"),
    ("    reinterpret_cast<float4*>(lut_sh)[i] = __ldg(src + i);\n  __syncthreads();\n",
     "    reinterpret_cast<float4*>(lut_sh)[i] = __ldg(src + i);\n  __syncthreads();\n" + LK_PROF % 0 + "\n"),
    ("      insert<R>(ss, sr, score_row<BPR>(codes + int64_t(row) * BPR, lut_sh), row, lo);\n",
     "      insert<R>(ss, sr, score_row<BPR>(codes + int64_t(row) * BPR, lut_sh), row, lo);\n" + LK_PROF % 1 + "\n"),
    ("    if (lane < r) {\n      const int64_t o = (t * nprobe + j) * r + lane;",
     LK_PROF % 2 + "\n    if (lane < r) {\n      const int64_t o = (t * nprobe + j) * r + lane;"),
    ("      out_r[o] = my_r;\n    }\n", "      out_r[o] = my_r;\n    }\n" + LK_PROF % 3 + "\n"),
]

# ---- route "onehot" ----
OH_MMA = ("        wgmma_oh<NV>(jj % 2 ? dd : de, as[jj], sw128_desc(lut_slot + jj * 32), decltype(first)::value ? jj > 1 : 1);\n")
OH_WALK = ("        topr::walk_stage<R, SC_STRIDE>(h, tiles + (ps % 2) * (TILE_BUF / 4) + part * TILE * SC_STRIDE + tok,\n"
           "                                       p0 - lo + part * TILE, rows);\n")
OH_WALK_NONE = "        h[0] += __float_as_uint(tiles[(ps % 2) * (TILE_BUF / 4) + part * TILE * SC_STRIDE + tok]);\n"
OH_LUT = "          if (16 * i < nv) cp_async16(base + dst[i], src[i] ? src[i] + s * SUBS * 16 : lut, src[i] ? 16 : 0);\n"
OH_LUT_NONE = "          (void)src;\n"


def timed_wait(anchor, slot, thread):
    """The wait at `anchor` (a line of mbar_wait) timed by one thread of its role into g_prof[slot]."""
    call = anchor.split("//")[0].strip().rstrip(";")
    indent = anchor[: len(anchor) - len(anchor.lstrip())]
    return (anchor, f"{indent}{{ const long long t0 = clock64(); {call}; if (threadIdx.x == {thread}) "
                    f"atomicAdd(&g_prof[{slot}], (unsigned long long)(clock64() - t0)); }}\n")


OH_WAITS = ("consumer: LUT stage", "consumer: tile free", "consumer: item", "walker: tile",
            "producer: ring slot free", "producer: item slot free", "producer: codes buffer free", "walker: item")
OH_TIMED = [
    ("#include \"topr.cuh\"\n", "#include \"topr.cuh\"\n__device__ unsigned long long g_prof[8];\n"),
    timed_wait("      mbar_wait(&sh.lut_full[slot], (st / STAGES) & 1);\n", 0, "0"),
    timed_wait("      mbar_wait(&sh.tile_empty[ps % 2], ((ps / 2) & 1) ^ 1);\n", 1, "0"),
    ("    mbar_wait(&sh.item_full[k % 2], (k / 2) & 1);\n    const Item& it = sh.item[k % 2];\n    const bool stop",
     "    { const long long t0 = clock64(); mbar_wait(&sh.item_full[k % 2], (k / 2) & 1); if (threadIdx.x == 0) "
     "atomicAdd(&g_prof[2], (unsigned long long)(clock64() - t0)); }\n    const Item& it = sh.item[k % 2];\n"
     "    const bool stop"),
    timed_wait("      mbar_wait(&sh.tile_full[ps % 2], (ps / 2) & 1);\n", 3, "WALKER"),
    timed_wait("        mbar_wait(&sh.lut_empty[slot], ((st / STAGES) & 1) ^ 1);\n", 4, "PRODUCER"),
    timed_wait("    mbar_wait(&sh.item_empty[k % 2], ((k / 2) & 1) ^ 1);\n", 5, "PRODUCER"),
    timed_wait("      mbar_wait(&sh.codes_empty[ps % 2], ((ps / 2) & 1) ^ 1);\n", 6, "PRODUCER"),
    ("    mbar_wait(&sh.item_full[k % 2], (k / 2) & 1);\n    const Item& it = sh.item[k % 2];\n    if (it.stop) return;",
     "    { const long long t0 = clock64(); mbar_wait(&sh.item_full[k % 2], (k / 2) & 1); if (threadIdx.x == WALKER) "
     "atomicAdd(&g_prof[7], (unsigned long long)(clock64() - t0)); }\n    const Item& it = sh.item[k % 2];\n"
     "    if (it.stop) return;"),
]
READ = ('}  // extern "C"',
        'int pq4_prof_read(void* out) { return int(cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof))); }\n'
        'int pq4_prof_reset() { unsigned long long z[8] = {0}; '
        'return int(cudaMemcpyToSymbol(g_prof, z, sizeof(z))); }\n'
        '}  // extern "C"')

VARIANTS = {
    "lookup": {
        "design": [],
        "no merge": [(LK_MERGE, "    my_s = ss[0];\n    my_r = sr[R - 1];\n"
                      "    for (int i = 0; i < 0; ++i) {\n      float bs = ss[0];")],
        "loads only": [(LK_LUT, "    ae += float(b & 15u);\n    ao += float(b >> 4);")],
        "no code loads": [(LK_LOAD, "      const uint4 q = make_uint4(uint32_t(size_t(src)) + v, 0x9e3779b9u * "
                                    "uint32_t(size_t(src)), 0x85ebca6bu ^ v, 0xc2b2ae35u + uint32_t(size_t(src)));")],
        "timed": LK_TIMED + [READ],
    },
    "onehot": {
        "design": [],
        "no products": [(OH_MMA, "")],
        "no walk": [(OH_WALK, OH_WALK_NONE)],
        "staging only": [(OH_MMA, ""), (OH_WALK, OH_WALK_NONE)],
        "products only": [(OH_WALK, OH_WALK_NONE), (OH_LUT, OH_LUT_NONE)],
        "timed": OH_TIMED + [READ],
    },
}


def build(out: Path, keys):
    """Each (route, variant) of ``keys`` built by its own nvcc, all at once, and loaded."""
    from colbert_tpu_torch.ops import _build

    csrc = ROOT / "colbert_tpu_torch/csrc"
    src = (csrc / "pq4_scan.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    procs = {}
    for route, name in keys:
        edits = VARIANTS[route][name]
        s = src
        for a, b in edits:
            if a not in s:
                raise RuntimeError(f"variant {route} {name!r}: {a!r} is not in pq4_scan.cu")
            s = s.replace(a, b)
        stem = f"{route}_{name.replace(' ', '_')}"
        (out / f"{stem}.cu").write_text(s)
        procs[(route, name)] = (stem, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{stem}.so"), str(out / f"{stem}.cu")],
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for key, (stem, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{err}")
        for line in err.splitlines():
            if key[1] == "design" and ("registers" in line or "spill" in line or "wgmma" in line):
                print(f"[build] {key[0]}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(out / f"{stem}.so"))
        lib.pq4_scan_launch.argtypes = LOOKUP_LAUNCH_ARGS
        lib.pq4_onehot_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.pq4_scan_launch.restype = lib.pq4_onehot_launch.restype = ctypes.c_int
        libs[key] = lib
    return libs


BUILD_DIR = ROOT / ".runs" / "pq4_scan_variants"
LOOKUP_LAUNCH_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def lookup_phase_split(lists, offsets, lut, codes, r):
    """Step 0 on the given inputs: route "lookup"'s "timed" variant (built
    here) launched once; returns ({phase: share of its warps' cycles},
    cycles a warp)."""
    import torch

    lib = build(BUILD_DIR, [("lookup", "timed")])[("lookup", "timed")]
    for fn in (lib.pq4_prof_read, lib.pq4_prof_reset):
        fn.restype = ctypes.c_int
    lib.pq4_prof_read.argtypes = [ctypes.c_void_p]
    T, nprobe = lists.shape
    out_s = torch.empty((T, nprobe, r), device=lists.device)
    out_r = torch.empty((T, nprobe, r), dtype=torch.int32, device=lists.device)
    lut32 = lut.to(torch.bfloat16).float().contiguous()
    lib.pq4_prof_reset()
    err = lib.pq4_scan_launch(lists.data_ptr(), offsets.data_ptr(), lut32.data_ptr(), codes.data_ptr(),
                              out_s.data_ptr(), out_r.data_ptr(), T, nprobe, codes.shape[1], r,
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"route lookup (timed) launch failed: cudaError_t {err}")
    torch.cuda.synchronize()
    prof = (ctypes.c_ulonglong * 8)()
    lib.pq4_prof_read(ctypes.addressof(prof))
    total = sum(prof[i] for i in range(len(LK_PHASES)))
    return {ph: prof[i] / total for i, ph in enumerate(LK_PHASES)}, total / (T * 8)


def serving_input(dev):
    """A seeded list layout, probes, LUT and codes of the serving shape."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    pop = rng.normal(size=K)                                   # list popularity
    lens = np.clip(np.rint(78 * np.exp(0.05 * pop + 0.45 * rng.normal(size=K))), 0, 463).astype(np.int64)
    lens[np.argmax(pop)] = 463                                 # the corpus's longest list, probed most
    offsets = np.zeros(K + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    codes = torch.from_numpy(rng.integers(-128, 128, size=(int(offsets[-1]), M // 2)).astype(np.int8)).to(dev)
    coarse = torch.from_numpy(rng.normal(size=(T, K)) + 0.9 * pop).float().to(dev)
    lists = torch.topk(coarse, NPROBE, dim=1)[1].int()
    lut = torch.from_numpy(rng.normal(scale=0.05, size=(T, M, 16)).astype(np.float32)).to(dev)
    return lists, torch.from_numpy(offsets).to(dev), lut, codes


def main() -> int:
    import torch

    from colbert_tpu_torch.ops import pq4

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--routes", default="lookup,onehot")
    routes = ap.parse_args().routes.split(",")
    if not torch.cuda.is_available():
        print("pq4_scan_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    libs = build(BUILD_DIR, [(route, name) for route in routes for name in VARIANTS[route]])
    dev = torch.device("cuda")
    lists, offsets, lut, codes = serving_input(dev)
    lens = torch.diff(offsets).long()
    members = torch.zeros(K, dtype=torch.long, device=dev).scatter_add_(
        0, lists.reshape(-1).long(), torch.ones(T * NPROBE, dtype=torch.long, device=dev))
    probed = members > 0
    print(f"input: {T} tokens x {NPROBE} lists of {K} ({int(probed.sum())} probed); probed list rows median "
          f"{float(lens[probed].double().median()):.0f}, max {int(lens[probed].max())}; members a probed list "
          f"median {float(members[probed].double().median()):.0f}, max {int(members.max())}; "
          f"{int(lens[lists.long()].sum())} (token, row) pairs", flush=True)
    want = pq4.pq4_list_scan_ref(lists, offsets, lut, codes, r=R)[0]
    P = T * NPROBE
    lut32 = lut.to(torch.bfloat16).float().contiguous()
    lut16 = lut.to(torch.bfloat16).contiguous()
    work = torch.empty(pq4._work_words(P, K) + P, dtype=torch.int32, device=dev)  # room for smaller groups
    out_s = torch.empty((T, NPROBE, R), device=dev)
    out_r = torch.empty((T, NPROBE, R), dtype=torch.int32, device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def run(route, lib):
        if route == "lookup":
            err = lib.pq4_scan_launch(lists.data_ptr(), offsets.data_ptr(), lut32.data_ptr(), codes.data_ptr(),
                                      out_s.data_ptr(), out_r.data_ptr(), T, NPROBE, M // 2, R, stream())
        else:
            err = lib.pq4_onehot_launch(lists.data_ptr(), offsets.data_ptr(), lut16.data_ptr(), codes.data_ptr(),
                                        work.data_ptr(), out_s.data_ptr(), out_r.data_ptr(), T, NPROBE, K,
                                        M // 2, R, stream())
        if err:
            raise RuntimeError(f"{route} launch failed: cudaError_t {err}")

    def ms(fn, iters=20):
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
    clock = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True).stdout.split()[0]) * 1e6
    print(label, flush=True)
    fin = torch.isfinite(want)
    for (route, name), lib in libs.items():
        try:
            t = ms(lambda: run(route, lib))
        except RuntimeError as e:  # one variant's fault does not hide the others' numbers
            print(f"{route:7s} {name:14s} {e}", flush=True)
            continue
        ok = torch.equal(fin, torch.isfinite(out_s))
        err = float((out_s[fin] - want[fin]).abs().max()) if ok else float("inf")
        print(f"{route:7s} {name:14s} {t:.4f} ms  max|d| {err:.1e}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for route, name in [k for k in libs if "timed" in k[1]]:
        lib = libs[(route, name)]
        for fn in (lib.pq4_prof_read, lib.pq4_prof_reset):
            fn.restype = ctypes.c_int
        lib.pq4_prof_read.argtypes = [ctypes.c_void_p]
        lib.pq4_prof_reset()
        run(route, lib)
        torch.cuda.synchronize()
        prof = (ctypes.c_ulonglong * 8)()
        lib.pq4_prof_read(ctypes.addressof(prof))
        cycles = ms(lambda: run(route, lib)) * 1e-3 * clock
        if route == "lookup":
            total = sum(prof[i] for i in range(len(LK_PHASES)))
            print("timed lookup: share of warp cycles by phase: "
                  + ", ".join(f"{p} {prof[i] / total:.3f}" for i, p in enumerate(LK_PHASES))
                  + f"; {total / (T * 8):.0f} cycles a warp; the kernel {cycles:.0f} cycles at "
                  f"{clock / 1e6:.0f} MHz", flush=True)
        else:
            grid = min(pq4.max_items(P, K), sms)  # one block an SM
            print(f"{name} onehot: grid {grid}; cycles a block waiting, by role and barrier: "
                  + ", ".join(f"{p} {prof[i] / grid:.0f}" for i, p in enumerate(OH_WAITS))
                  + f"; the kernel {cycles:.0f} cycles at {clock / 1e6:.0f} MHz", flush=True)
    for route in routes:
        wrapper = lambda: pq4._launch(lists, offsets, lut, codes, R, route=route)
        print(f"route {route:7s} {ms(wrapper):.4f} ms (wrapper)", flush=True)
    if "onehot" in routes:
        print(f"work list      {ms(lambda: pq4.work_list_kernel(lists, offsets)):.4f} ms (its kernels alone)",
              flush=True)
    print(label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
