"""Flash attention's kernels at head dim 64 against another checkout's build, on the card.

Builds ``colbert_tpu_torch/csrc/flash_attention.cu`` and the
``colbert_tpu_torch/csrc`` of another checkout under DIR (with that
checkout's C interface: the one that passes the head dim, if its library
exports ``flash_head_dims`` or ``flash_head_dim_template``, else the older
one that passes none and takes 64 alone), then:

* at head dim 64, every output of the two builds (o, l, m, di, 1 / l, dk,
  dv, dq) bit-equal, bf16, fp16 and fp32, at two shapes in the models'
  layout with ragged segments and query segments no key has;
* with ``--time``, K11, the rows kernel, K12 and K13 of both builds at the
  retriever's doc pass (68, 12, 384, 64) and, where the other build takes
  head dims, at (68, 8, 384, 128) (``--dims``: at the head dims given, 12
  heads up to 64 and 8 above, as phase 8a has them), bf16 and fp32, timed cold as
  ``chip_smoke.py`` times them (CUDA events, input copies in turn past
  twice the L2), the builds in turns (this, the parent, the parent, this)
  four times, the medians of each build's eight runs kept;
* with ``--sass``, the opcodes of each head-dim-64 kernel's hot loop in both
  builds (``scripts/flash_variants.py``'s ``sass_counts``), and the whole
  SASS of those kernels written to ``chiprun_out/flash_parent_sass_*.txt``
  for a diff.

Writes ``chiprun_out/flash_parent.json``; exits 1 if any output differs.

    git archive HEAD colbert_tpu_torch/csrc | tar -x -C .runs/parent
    python3 scripts/flash_parent.py .runs/parent [--time [--dims 26,80,96,128]] [--sass]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def demangled(names) -> dict:
    try:
        got = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True, check=True).stdout
        return dict(zip(names, got.splitlines()))
    except (OSError, subprocess.CalledProcessError):
        return {n: n for n in names}


def parent_fns(csrc: Path, so: Path):
    """The parent checkout's four C entry points, built from ``csrc`` into
    ``so``, as functions of this checkout's argument lists, and whether its
    interface passes the head dim (else it takes 64 alone)."""
    from colbert_tpu_torch.ops import _build, flash_attention as fa

    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{csrc}", "-o", str(so), str(csrc / "flash_attention.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    fns = (lib.flash_fwd_launch, lib.flash_bwd_dkv_launch, lib.flash_bwd_dq_launch, lib.flash_bwd_rows_launch)
    if hasattr(lib, "flash_head_dims") or hasattr(lib, "flash_head_dim_template"):  # it passes the head dim
        fa.bind(lib, check=False)
        return fns, True
    # the interface before it: no head dim after the lengths, and 64 alone
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    view = ctypes.c_longlong * 3
    tail = [i, i, i, i, f, i, i, ptr]
    routed = tail[:6] + [i] + tail[6:]
    lib.flash_fwd_launch.argtypes = [ptr] * 8 + [view] * 4 + routed
    lib.flash_bwd_dkv_launch.argtypes = [ptr] * 12 + [view] * 6 + routed
    lib.flash_bwd_dq_launch.argtypes = [ptr] * 11 + [view] * 5 + routed
    lib.flash_bwd_rows_launch.argtypes = [ptr] * 5 + [view] * 2 + [i, i, i, i, i, ptr]
    for fn in fns:
        fn.restype = i

    def dropping(fn, at):
        return lambda *a: fn(*a[:at], *a[at + 1:])
    # the head dim's place in this checkout's lists: after Lk (K11: 16, K12: 22, K13: 20), after L (rows: 10)
    return tuple(dropping(fn, at) for fn, at in zip(fns, (16, 22, 20, 10))), False


def inputs(device, dtype, B, nh, L, seed, unseen=False, hd=64):
    import torch

    g = torch.Generator(device).manual_seed(seed)
    heads = lambda: torch.randn((B, L, nh, hd), generator=g, device=device).to(dtype).transpose(1, 2)
    q, k, v, do = heads(), heads(), heads(), heads()
    lengths = torch.randint(1, L + 1, (B,), generator=g, device=device)
    lengths[0] = L
    seg = (torch.arange(L, device=device)[None, :] < lengths[:, None]).to(torch.int32)
    q_seg = seg
    if unseen:  # every third query in segment 2, which no key has
        q_seg = torch.where(torch.arange(L, device=device)[None, :] % 3 == 1, 2, seg).to(torch.int32)
    return (q, k, v, q_seg, seg, 0.125), do


def run_kernels(args, do):
    """(o, l, m, di, 1 / l) from K11 and the rows kernel."""
    from colbert_tpu_torch.ops import flash_attention as fa

    o, l, m = fa._launch_forward(*args)
    di, inv_l = fa._launch_rows(o, do, l)
    return o, l, m, di, inv_l


def parent_same(device, fns_new, fns_old, dtype, B, nh, L, seed) -> dict:
    """Every output at head dim 64 from both builds on the same inputs, bit for bit."""
    import torch

    from colbert_tpu_torch.ops import flash_attention as fa

    args, do = inputs(device, dtype, B, nh, L, seed, unseen=True)
    outs = {}
    for which, fns in (("new", fns_new), ("parent", fns_old)):
        fa._resolved = fns
        o, l, m, di, inv_l = run_kernels(args, do)
        own = (*args, l, m, do, di)
        dk, dv = fa._launch_dkv(*own, inv_l=inv_l)
        dq = fa._launch_dq(*own, inv_l=inv_l)
        outs[which] = (o, l, m, di, inv_l, dk, dv, dq)
    fa._resolved = fns_new
    torch.cuda.synchronize()
    names = ("o", "l", "m", "di", "inv_l", "dk", "dv", "dq")
    equal = {n: bool(torch.equal(a, b)) for n, a, b in zip(names, outs["new"], outs["parent"])}
    return {"shape": [B, nh, L, 64], "dtype": str(dtype).split(".")[-1], "equal": equal, "ok": all(equal.values())}


def time_against_parent(device, fns_new, fns_old, dtype, rounds=4, hd=64) -> dict:
    """Cold ms of K11, the rows kernel, K12 and K13 at (68, nh, 384, hd) for
    each build, in turns; the medians of each build's ``2 * rounds`` runs."""
    import numpy as np

    import chip_smoke
    from colbert_tpu_torch.ops import flash_attention as fa

    nh = 12 if hd <= 64 else 8  # phase 8a's shapes: (68, 12, 384, 26 / 32 / 64), (68, 8, 384, 80 / 96 / 128)
    args, do = inputs(device, dtype, 68, nh, 384, seed=68 * 384, hd=hd)
    q, k, v, q_seg, seg, scale = args
    fa._resolved = fns_new
    o, l, m, di, inv_l = run_kernels(args, do)
    n = max(1, -(-4 * chip_smoke.L2_BYTES // (4 * q.numel() * q.element_size())))
    copies = [tuple(t.clone() for t in (q, k, v, do)) for _ in range(n)]
    outs = [tuple(t.clone() for t in (o, do)) for _ in range(n)]
    parts = {"K11": (lambda x, i: fa._launch_forward(x[0], x[1], x[2], q_seg, seg, scale), copies),
             "rows": (lambda x, i: fa._launch_rows(x[0], x[1], l), outs),
             "K12": (lambda x, i: fa._launch_dkv(x[0], x[1], x[2], q_seg, seg, scale, l, m, x[3], di,
                                                 inv_l=inv_l), copies),
             "K13": (lambda x, i: fa._launch_dq(x[0], x[1], x[2], q_seg, seg, scale, l, m, x[3], di,
                                                inv_l=inv_l), copies)}
    runs = {which: {key: [] for key in parts} for which in ("change", "parent")}
    for _ in range(rounds):
        for which in ("change", "parent", "parent", "change"):
            fa._resolved = fns_new if which == "change" else fns_old
            for key, (fn, xs) in parts.items():
                runs[which][key].append(chip_smoke.time_ms(chip_smoke.in_turn(fn, xs), warmup=len(xs) + 2))
    fa._resolved = fns_new
    return {"dtype": str(dtype).split(".")[-1], "shape": [68, nh, 384, hd], "cold_copies": n, "runs": runs,
            "ms": {which: {key: float(np.median(ts)) for key, ts in r.items()} for which, r in runs.items()}}


def hd64_sass(so: Path, parent: bool) -> dict:
    """The SASS of each head-dim-64 flash kernel in the library at ``so``
    (every kernel of a parent that takes 64 alone), by demangled name."""
    from colbert_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs = {f.split("\n", 1)[0].strip(): f for f in re.split(r"\n\s*Function : ", text)[1:]}
    names = demangled(list(funcs))
    return {names[k]: f for k, f in funcs.items()
            if "flash" in names[k] and (parent or ", 64" in names[k] or "<64>" in names[k])}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, help="a checkout whose colbert_tpu_torch/csrc to hold head dim 64 to")
    ap.add_argument("--time", action="store_true", help="time head dim 64 against the parent")
    ap.add_argument("--dims", default=None,
                    help="with --time, the head dims to time, comma-separated (default 64, and 128 where the "
                         "other build takes head dims)")
    ap.add_argument("--sass", action="store_true", help="the head-dim-64 kernels' SASS of both builds")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_parent: needs a CUDA card", file=sys.stderr)
        return 1
    from colbert_tpu_torch.ops import _build, flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    label = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(label, flush=True)
    t0 = time.perf_counter()
    _build.load_libraries("flash_attention")
    fns_new = fa._fns()
    build = ROOT / ".runs" / "flash_parent"
    build.mkdir(parents=True, exist_ok=True)
    so_old = build / "parent_flash_attention.so"
    fns_old, takes_hd = parent_fns(a.parent / "colbert_tpu_torch" / "csrc", so_old)
    print(f"[build] both builds in {time.perf_counter() - t0:.1f} s", flush=True)
    out = {"card": label, "parent": []}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for B, nh, L in ((68, 12, 384), (5, 4, 256)):
            r = parent_same(device, fns_new, fns_old, dtype, B, nh, L, seed=B * L)
            out["parent"].append(r)
            print(f"[parent] {json.dumps(r)}", flush=True)
    if a.sass:
        sys.path.insert(0, str(ROOT / "scripts"))
        import flash_variants

        short = lambda name: name.replace("(anonymous namespace)::", "").split("(")[0]
        out["sass"] = {}
        for which, so in (("parent", so_old), ("change", Path(fa._kernel_lib()._name))):
            counts = flash_variants.sass_counts(so)
            whole = hd64_sass(so, which == "parent")
            (ROOT / "chiprun_out").mkdir(exist_ok=True)
            (ROOT / "chiprun_out" / f"flash_parent_sass_{which}.txt").write_text(
                "".join(f"\n==== {name}\n{body}" for name, body in sorted(whole.items())))
            names = demangled(list(counts))
            out["sass"][which] = {short(names[k]): v for k, v in counts.items() if names[k] in whole}
            for k, v in out["sass"][which].items():
                print(f"[sass] {which} {k}: {json.dumps(v)}", flush=True)
    if a.time:
        dims = (64, 128) if takes_hd else (64,)  # an older parent takes 64 alone
        if a.dims:
            dims = tuple(int(d) for d in a.dims.split(","))
        out["times"] = [time_against_parent(device, fns_new, fns_old, dtype, hd=hd)
                        for hd in dims for dtype in (torch.bfloat16, torch.float32)]
        for r in out["times"]:
            print(f"[time] {r['dtype']} {r['shape']} cold ms, medians: {json.dumps(r['ms'])} [{label}]", flush=True)
    ok = all(r["ok"] for r in out["parent"])
    out["ok"] = ok
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "flash_parent.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({"ok": ok, "differ": [(r["shape"], r["dtype"]) for r in out["parent"] if not r["ok"]]}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
