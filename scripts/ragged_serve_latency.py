#!/usr/bin/env python3
"""Phase 9c of ``chip_smoke.py`` alone, from any checkout, on one NVIDIA GPU.

    python3 scripts/ragged_serve_latency.py [--root CHECKOUT]

Imports ``chip_smoke`` and ``colbert_tpu_torch`` from ``--root`` (this
checkout by default), encodes phase 2's corpus (20,000 synthetic passages,
a seeded random BERT-base), then runs phase 9c on its first 10,000
passages with multiview off: the served bf16 stride buckets over the socket
(two requests of 144 questions), one request each through an int8, a
host-table and a packed-dedup service, ``evaluate --remote``, every answer
checked against the exact MaxSim of its pids.  Prints the card's name and
power limit, phase 9c's lines (the request times among them) and one JSON
line of its result.  Two checkouts compare in one call, in turns (parent,
change, change, parent), each in a process of its own.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the checkout whose chip_smoke.py and colbert_tpu_torch run")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("ragged_serve_latency: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    label = cs.card_label()
    cs.log(f"{label}; checkout {args.root}")
    with tempfile.TemporaryDirectory(prefix="ragged_serve_latency_") as tmp:
        c = cs.encoded_corpus(device, Path(tmp), label)
        out = cs.phase_ragged_cli(device, Path(tmp), c["cfg"], c["common"], c["eval_path"], c["docs"],
                                  c["requests"], c["n_eval"], label)
    cs.log(json.dumps({"root": args.root, "latency_ms": out["latency_ms"], "max_abs_err": out["max_abs_err"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
