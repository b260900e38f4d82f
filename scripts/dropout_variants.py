#!/usr/bin/env python3
"""Split the dropout kernel K9's time on one NVIDIA GPU: its wrapper's host
time, and its kernel body's time on the card.

    python3 scripts/dropout_variants.py

Host, at the cross-encoder's hidden states (20, 384, 1024) bf16: the
host's microseconds a call (the host clock over 200 calls with no
synchronisation inside; 7 runs in each of two turns, the cases in order
and then in reverse; the least and the median) and, as ``chip_smoke.py``
phase 3 times a call, CUDA events over 20 calls with the host issuing
them (one in each turn).  First the first design's wrapper (``ops/dropout.py``
as it was before the "packed" route, rebuilt here from its parts; it now
passes the C function the two arguments the route and the device take),
then that wrapper with each part
removed or replaced in turn by what the current wrapper does:
``keep_scale``'s tensor round trip (a cached float), ``_kernel_lib()``
with its two locks (a handle resolved once), the ``torch.cuda.device``
context (none: the C function switches the device if it must),
``torch.cuda.current_stream(dev).cuda_stream`` (the raw stream),
``torch.empty_like`` (an output allocated before), the ctypes call (none:
no launch), the ``LaunchCounter``'s lock (none) and
``_HwDropout.apply`` (none); then every part replaced, the current
``hw_dropout`` on both routes, a bare ctypes call that launches nothing,
and ``F.dropout`` with and without ``requires_grad``; last
``hw_dropout`` with it, as the models call it, and its parts: ``_launch``
alone (no autograd node), an autograd node whose forward only allocates,
and ``_launch`` without its two counters.

Device, at the three bf16 shapes K9 runs at, (68, 12, 384, 384), (20, 16,
384, 384) and (20, 384, 1024): each variant's time on the card alone (the
stream waits behind a spin kernel while the host queues 20 calls), in two
turns (forward order, then reverse): route "simple" (the first design),
"simple" with Philox replaced by a constant word (memory and the selects
alone), "simple" without its stores (the loaded values folded into one
word stored only if it takes an unlikely value), route "packed", "packed"
taking at every size the way it takes for a tensor that fits in L2 (plain
loads and stores, a grid of the resident blocks) and the way it takes past
it (``__ldcs``/``__stcs``, a block for every 8 tiles), "packed" with four
16-byte chunks a lane a pass instead of two, "packed" with a constant word
and "packed" without stores, and ``y.copy_(x)`` over the same bytes (the
ceiling of a read-once, write-once pass; no kernel of the port).  The
variants are the kernel's source with lines swapped, built with nvcc into
``.runs/dropout_variants/``.  Routes "simple", "packed" and both ways of
"packed" must be bit-equal to the plain version.  Last, the static
instruction mix of each route's vector loop (``cuobjdump -sass``: route
"simple" as its vector path alone).

Prints the card's name and power limit and one line a measurement.
"""

from __future__ import annotations

import contextlib
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import card_label, device_ms, sass_loop_mix, time_ms  # noqa: E402

SHAPES = ((68, 12, 384, 384), (20, 16, 384, 384), (20, 384, 1024))
HIDDEN = (20, 384, 1024)
THR, SEED = 26, 0x9E3779B97F4A7C15

SIMPLE_PHILOX = "    const uint4 r = philox4x32_10(make_uint4((uint32_t)i, (uint32_t)(i >> 32), 0u, 0u), k0, k1);\n"
SIMPLE_LOOP = "  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < groups; i += stride) {\n"
SIMPLE_STORE = "      for (int q = 0; q < kVecs; ++q) dst[q] = buf[q];\n"
SIMPLE_END = "      scalar_group(x, y, e0, n, r, thr, scale);\n    }\n  }\n}\n"
PACKED_PHILOX = "philox_keyed((uint32_t)g, (uint32_t)(g >> 32), keys)"
PACKED_LOOP = "  uint4* dst = reinterpret_cast<uint4*>(y);\n"
PACKED_STORE = "    for (int j = 0; j < kChunks; ++j) store_out<STREAM>(dst + c0 + 32 * j, v[j]);\n  }\n"
PACKED_CHUNKS = "constexpr int kChunks = 2;"
PACKED_WAY = "  const bool streaming = (long long)sizeof(T) * n > l2;\n"
SINK = "sink ^= {0}.x ^ {0}.y ^ {0}.z ^ {0}.w;\n"

# name -> (route the variant's library is called with, [(old, new), ...])
VARIANTS = {
    "simple, constant word": (1, [(SIMPLE_PHILOX, "    const uint4 r = make_uint4(k0, k1, k0 ^ k1, k0 + k1);\n")]),
    "simple, no stores": (1, [(SIMPLE_LOOP, "  uint32_t sink = 0;\n" + SIMPLE_LOOP),
                              (SIMPLE_STORE, "      for (int q = 0; q < kVecs; ++q) " + SINK.format("buf[q]")),
                              (SIMPLE_END, SIMPLE_END[:-2] + "  if (sink == 0x9E3779B9u) y[0] = x[0];\n}\n")]),
    "simple, vector path alone": (1, [("    } else {\n      scalar_group(x, y, e0, n, r, thr, scale);\n    }\n",
                                       "    }\n")]),
    "packed, the in-L2 way at every size": (0, [(PACKED_WAY, "  const bool streaming = false;\n")]),
    "packed, the streaming way at every size": (0, [(PACKED_WAY, "  const bool streaming = true;\n")]),
    "packed, four chunks a lane": (0, [(PACKED_CHUNKS, "constexpr int kChunks = 4;")]),
    "packed, constant word": (0, [(PACKED_PHILOX, "make_uint4(keys.k0[0], keys.k1[0], keys.k0[1], keys.k1[1])")]),
    "packed, no stores": (0, [(PACKED_LOOP, PACKED_LOOP + "  uint32_t sink = 0;\n"),
                              (PACKED_STORE, "    for (int j = 0; j < kChunks; ++j) " + SINK.format("v[j]")
                               + "  }\n  if (sink == 0x9E3779B9u) y[0] = x[0];\n")]),
}


def build_variants():
    """Each variant's source into ``.runs/dropout_variants/``, one nvcc each, all at once."""
    from colbert_tpu_torch.ops import _build

    src = (_build.CSRC / "dropout.cu").read_text()
    out = ROOT / ".runs" / "dropout_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (_, swaps)) in enumerate(VARIANTS.items()):
        text = src
        for old, new in swaps:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: anchor not found once in dropout.cu: {old!r}")
            text = text.replace(old, new)
        (out / f"v{i}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(out / f"v{i}.so"), str(out / f"v{i}.cu")]
        procs[name] = (out / f"v{i}.so", subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed building {name}:\n{err}")
        lib = ctypes.CDLL(str(so))
        lib.dropout_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.dropout_launch.restype = ctypes.c_int
        libs[name] = (so, lib)
    return libs


def host_us(fn, calls=200, runs=7) -> list:
    """The host's microseconds a call in each of ``runs`` runs of ``calls``
    calls with no synchronisation inside (fewer than the launch queue holds)."""
    import torch

    for _ in range(3):
        fn()
    got = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        got.append((time.perf_counter() - t) / calls * 1e6)
    torch.cuda.synchronize()
    return got


def pr2_wrapper(skip=frozenset()):
    """The first design's wrapper (``hw_dropout`` -> ``_HwDropout.apply`` ->
    ``_apply`` -> ``_launch``), with the parts named in ``skip`` removed or
    replaced by what the current wrapper does."""
    import torch

    from colbert_tpu_torch.ops import dropout as dr
    from colbert_tpu_torch.ops._build import LaunchCounter, load_library

    counter, cached = LaunchCounter(), dr._kernel_lib().dropout_launch
    y_before = torch.empty(HIDDEN, dtype=torch.bfloat16, device="cuda")

    def kernel_lib():
        lib = load_library("dropout")
        with dr._lib_lock:
            if lib.dropout_launch.argtypes is None:
                raise RuntimeError("argtypes not set")
        return lib

    def launch(x, seed, thr):
        if x.dtype not in dr._DTYPES:
            raise ValueError(x.dtype)
        fn = cached if "_kernel_lib" in skip else kernel_lib().dropout_launch
        xc = x.contiguous()
        y = y_before if "empty_like" in skip else torch.empty_like(xc)
        vec_ok = int(xc.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)  # noqa: F841 (the first design's)
        ctx = contextlib.nullcontext() if "device context" in skip else torch.cuda.device(xc.device)
        with ctx:
            scale = dr._scale(thr, x.dtype) if "keep_scale" in skip else dr.keep_scale(thr, x.dtype)
            stream = (torch._C._cuda_getCurrentRawStream(xc.get_device()) if "current_stream" in skip
                      else torch.cuda.current_stream(xc.device).cuda_stream)
            err = 0 if "ctypes call" in skip else fn(xc.data_ptr(), y.data_ptr(), xc.numel(), dr._DTYPES[x.dtype],
                                                     seed, thr, scale, 0, xc.get_device(), stream)
        if err != 0:
            raise RuntimeError(f"cudaError_t {err}")
        if "LaunchCounter" not in skip:
            counter.add()
        return y.view(x.shape)

    def apply(x, seed, thr):
        if x.device.type == "cpu":
            raise ValueError("a CUDA tensor")
        return launch(x, seed, thr)

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, seed, thr):
            ctx.seed, ctx.thr = seed, thr
            return apply(x, seed, thr)

        @staticmethod
        def backward(ctx, grad):
            return apply(grad, ctx.seed, ctx.thr), None, None

    def call(x, seed, thr):
        if not 1 <= thr <= 255:
            raise ValueError(f"dropout threshold must be 1..255 (of 256), got {thr}")
        if not 0 <= seed < 1 << 64:
            raise ValueError(f"dropout seed must fit 64 bits unsigned, got {seed}")
        if "autograd.Function" in skip:
            return apply(x, seed, thr)
        return Fn.apply(x, seed, thr)

    return call


PARTS = ("keep_scale", "_kernel_lib", "device context", "current_stream", "empty_like", "ctypes call",
         "LaunchCounter", "autograd.Function")


def host_split():
    import torch
    import torch.nn.functional as F

    from colbert_tpu_torch.ops import dropout as dr

    x = torch.randn(HIDDEN, device="cuda", dtype=torch.bfloat16)
    xg = x.clone().requires_grad_(True)
    fn = dr._kernel_lib().dropout_launch
    y = torch.empty_like(x)
    stream = torch._C._cuda_getCurrentRawStream(0)
    scale = dr._scale(THR, x.dtype)

    class Alloc(torch.autograd.Function):
        """A node whose forward only allocates: an autograd node's host cost with one allocation."""

        @staticmethod
        def forward(ctx, t):
            return torch.empty_like(t)

        @staticmethod
        def backward(ctx, g):
            return g

    def launch_uncounted(t):
        out = torch.empty_like(t)
        fn(t.data_ptr(), out.data_ptr(), t.numel(), 1, SEED, THR, scale, 0, 0, torch._C._cuda_getCurrentRawStream(0))
        return out

    cases = [("first design's wrapper", lambda f=pr2_wrapper(): f(x, SEED, THR))]
    cases += [(f"  without {part}", lambda f=pr2_wrapper(frozenset([part])): f(x, SEED, THR)) for part in PARTS
              if part != "ctypes call"]
    cases += [("  without the ctypes call (no launch)", lambda f=pr2_wrapper(frozenset(["ctypes call"])): f(x, SEED, THR)),
              ("  every part replaced but the allocation and the launch",
               lambda f=pr2_wrapper(frozenset(PARTS) - {"ctypes call", "empty_like"}): f(x, SEED, THR)),
              ("hw_dropout (route packed), no graph", lambda: dr.hw_dropout(x, SEED, THR)),
              ("_launch(route='simple')", lambda: dr._launch(x, SEED, THR, route="simple")),
              ("a bare ctypes call, n = 0 (launches nothing)",
               lambda: fn(x.data_ptr(), y.data_ptr(), 0, 1, SEED, THR, 1.0, 0, 0, stream)),
              ("torch.empty_like alone", lambda: torch.empty_like(x)),
              ("F.dropout", lambda: F.dropout(x, p=THR / 256, training=True)),
              ("F.dropout, requires_grad", lambda: F.dropout(xg, p=THR / 256, training=True)),
              ("hw_dropout, requires_grad", lambda: dr.hw_dropout(xg, SEED, THR)),
              ("  _launch alone (route packed: no autograd node)", lambda: dr._launch(x, SEED, THR)),
              ("  an autograd node around torch.empty_like, requires_grad", lambda: Alloc.apply(xg)),
              ("  _launch without its two counters", lambda: launch_uncounted(x))]
    runs = {name: [] for name, _ in cases}
    events = {name: [] for name, _ in cases}
    for turn in (cases, cases[::-1]):
        for name, call in turn:
            runs[name] += host_us(call)
            events[name].append(time_ms(call))
    print(f"host split at {HIDDEN} bf16 (a call's host us over 200 calls: least and median of 14 runs in two turns; "
          f"time_ms: CUDA events over 20 calls issued by the host, as chip_smoke.py phase 3, one a turn)")
    for name, _ in cases:
        print(f"  {name}: host {min(runs[name]):.2f} us (median {statistics.median(runs[name]):.2f}) a call; "
              f"time_ms {events[name][0]:.4f} / {events[name][1]:.4f} ms")


def device_split():
    import torch

    from colbert_tpu_torch.ops import dropout as dr

    libs = build_variants()
    stream = torch._C._cuda_getCurrentRawStream(0)
    scale = dr._scale(THR, torch.bfloat16)

    def via(lib, route, x, y):
        def run():
            err = lib.dropout_launch(x.data_ptr(), y.data_ptr(), x.numel(), 1, SEED, THR, scale, route, 0, stream)
            if err:
                raise RuntimeError(f"cudaError_t {err}")
            return y
        return run

    ok = True
    for shape in SHAPES:
        x = torch.randn(shape, device="cuda", dtype=torch.bfloat16)
        y = torch.empty_like(x)
        runs = {"simple": lambda: dr._launch(x, SEED, THR, route="simple"),
                "packed": lambda: dr._launch(x, SEED, THR)}
        runs.update({name: via(lib, VARIANTS[name][0], x, y) for name, (_, lib) in libs.items()
                     if name != "simple, vector path alone"})
        runs["copy_ (no kernel of the port)"] = lambda: y.copy_(x)
        want = dr.hw_dropout_ref(x, SEED, THR)
        for name in ("simple", "packed", "packed, the in-L2 way at every size", "packed, the streaming way at every size"):
            same = dr.same_bits(runs[name](), want)
            ok &= same
            if not same:
                print(f"  {shape} {name}: DIFFERS from the plain version")
        del want
        order = list(runs)
        times = {name: [] for name in order}
        for turn in (order, order[::-1]):
            for name in turn:
                times[name].append(device_ms(runs[name]))
        nbytes = 2.0 * x.numel() * x.element_size()
        bound = nbytes / 3.35e12 * 1e3
        print(f"device split at {shape} bf16 (on the card alone, mean of two turns; byte bound {bound:.4f} ms, "
              f"{nbytes / 1e6:.1f} MB at 3.35 TB/s; routes simple, packed and both ways of packed bit-equal: "
              f"{'yes' if ok else 'NO'}):")
        for name in order:
            t = sum(times[name]) / 2
            print(f"  {name}: {t:.4f} ms ({times[name][0]:.4f} / {times[name][1]:.4f}), byte bound at {bound / t:.1%}")
        del x, y, runs
    for name, so, parts, per_vec in (
            ("packed", dr._kernel_lib()._name, ("packed_kernel", "I13__nv_bfloat16Lb0ELb0ELb0E"), 8),
            ("packed, streaming way", dr._kernel_lib()._name, ("packed_kernel", "I13__nv_bfloat16Lb0ELb1ELb0E"), 8),
            ("simple, vector path alone", libs["simple, vector path alone"][0], ("simple_kernel", "I13__nv_bfloat16"), 8)):
        mix = sass_loop_mix(so, parts, per_vec)
        print(f"SASS, route {name} (bf16, thr < 128): {mix['loop_instructions']} instructions in its loop for "
              f"{mix['loop_elements']} elements: {mix['int_per_element']:.3f} INT32-pipe, {mix['imad_per_element']:.3f} "
              f"IMAD, {mix['all_per_element']:.3f} in all an element; {mix['opcodes']}")
    return ok


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dropout_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(card_label())
    host_split()
    return 0 if device_split() else 1


if __name__ == "__main__":
    sys.exit(main())
