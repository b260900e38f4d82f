"""K9 (dropout) on contiguous tensors against another checkout's build, on the card.

Builds ``colbert_tpu_torch/csrc/dropout.cu`` of this checkout and of the
checkout under DIR, then calls each build's ``dropout_launch`` (the C
interface both keep) on route "packed":

* every output of the two builds bit-equal, at the shapes ``chip_smoke.py``
  phase 3 holds K9 at (the retriever's (68, 12, 384, 384) bf16
  probabilities, the cross-encoder's (20, 16, 384, 384) bf16 probabilities
  and (20, 384, 1024) bf16 hidden states) and at the hidden states in fp32,
  at thresholds 26 and 200;
* each build's time on the card alone at those shapes, cold as phase 3
  times it (``chip_smoke.device_ms`` over copies of the input in turn, past
  twice the L2), the builds in turns (this, the parent, the parent, this)
  ``--rounds`` times, the medians of each build's runs kept.

Writes ``chiprun_out/dropout_parent.json`` and prints the card's name and
power limit; exits 1 if any output differs.

    mkdir -p .runs/parent && git archive HEAD colbert_tpu_torch/csrc | tar -x -C .runs/parent
    python3 scripts/dropout_parent.py .runs/parent [--rounds 4]
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

SHAPES = (((68, 12, 384, 384), "bfloat16"), ((20, 16, 384, 384), "bfloat16"), ((20, 384, 1024), "bfloat16"),
          ((20, 384, 1024), "float32"))
SEED = 0x9E3779B97F4A7C15


def build(csrc: Path, so: Path):
    """``dropout_launch`` of the source under ``csrc``, with its argtypes."""
    from colbert_tpu_torch.ops import _build

    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(csrc / "dropout.cu")], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).dropout_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, thr):
    """``x -> y``: route "packed" of the build ``fn`` from counter 0."""
    import torch

    from colbert_tpu_torch.ops import dropout as dr

    def call(x, _i=0):
        y = torch.empty_like(x)
        dev = x.get_device()
        err = fn(x.data_ptr(), y.data_ptr(), x.numel(), dr._DTYPES[x.dtype], SEED, thr, dr.keep_scale(thr, x.dtype),
                 0, dev, torch._C._cuda_getCurrentRawStream(dev))
        if err:
            raise RuntimeError(f"dropout_launch: cudaError_t {err}")
        return y
    return call


def main() -> int:
    import torch

    import chip_smoke
    from colbert_tpu_torch.ops import dropout as dr

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, help="a checkout (or its colbert_tpu_torch/csrc alone) to compare with")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dropout_parent: CUDA is not available", file=sys.stderr)
        return 1
    label = chip_smoke.card_label()
    print(label, flush=True)
    out_dir = ROOT / "chiprun_out"
    builds = {"this": build(ROOT / "colbert_tpu_torch" / "csrc", ROOT / ".runs" / "dropout_this.so"),
              "parent": build(args.parent / "colbert_tpu_torch" / "csrc", ROOT / ".runs" / "dropout_parent.so")}
    device = torch.device("cuda", 0)
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    rows, ok = [], True
    for shape, dtype in SHAPES:
        x = torch.randn(shape, device=device, dtype=getattr(torch, dtype))
        equal = {}
        for thr in (26, 200):
            got = {name: launcher(fn, thr)(x) for name, fn in builds.items()}
            equal[thr] = dr.same_bits(got["this"], got["parent"]) and dr.same_bits(
                got["this"], dr.hw_dropout_ref(x, SEED, thr))
            ok &= equal[thr]
        xs = [x] + [x.clone() for _ in range(-(-2 * l2 // (x.numel() * x.element_size())))]
        runs = {name: [] for name in builds}
        for _ in range(args.rounds):
            for name in ("this", "parent", "parent", "this"):
                runs[name].append(chip_smoke.device_ms(chip_smoke.in_turn(launcher(builds[name], 26), xs)))
        row = {"shape": list(shape), "dtype": dtype, "bit_equal": equal,
               "this_ms": statistics.median(runs["this"]), "parent_ms": statistics.median(runs["parent"]),
               "runs": runs, "cold_buffers": len(xs),
               "bound_ms": 2.0 * x.numel() * x.element_size() / chip_smoke.PEAK_HBM_BYTES * 1e3}
        rows.append(row)
        print(f"K9 route packed {tuple(shape)} {dtype}: bit-equal to the parent's build {equal}; cold on the card "
              f"alone, medians of {2 * args.rounds} runs in turns: this {row['this_ms']:.4f} ms, parent "
              f"{row['parent_ms']:.4f} ms (bound {row['bound_ms']:.4f}) [{label}]", flush=True)
        del xs, x
        torch.cuda.empty_cache()
    out_dir.mkdir(exist_ok=True)
    (out_dir / "dropout_parent.json").write_text(json.dumps({"card": label, "rows": rows, "ok": ok}, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
