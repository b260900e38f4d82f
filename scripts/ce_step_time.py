#!/usr/bin/env python3
"""Time cross-encoder training steps at macbert-large width on one NVIDIA GPU.

    python3 scripts/ce_step_time.py [--steps 8] [--root DIR]

The CE of ``configs/dureader.yaml`` (24 layers, hidden 1,024, 16 heads,
FFN 4,096, bf16, dropout 0.1 by the K9 kernel) from a seeded random init,
one batch of 4 questions x (1 + 4) passages of 384 tokens (random token
ids, every position real), ``CETrainer.train_step`` after two warm-up
steps.  Prints, for the timed steps: each step's ms on the host clock
(ending in a synchronise), the host's time inside K9's calls
(``ops.dropout._apply``, forward and backward: a step's sum, and a call's
least / median / mean), and, from ``torch.profiler`` over one more step,
the card's busy ms (kernel time summed) and K9's kernels' ms in it.

``--root`` imports ``colbert_tpu_torch`` from another checkout (say a
``git archive`` of a parent commit under ``.runs/``), so two versions are
timed by the same script; compare them only inside one call, in turns.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--root", default=str(ROOT), help="checkout whose colbert_tpu_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ce_step_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from colbert_tpu_torch.config import CETrainConfig, ColbertConfig, ModelConfig
    from colbert_tpu_torch.ops import dropout as dr
    from colbert_tpu_torch.training import CETrainer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    print(f"colbert_tpu_torch from {Path(dr.__file__).resolve().parent.parent}")
    batch, neg, seqlen, vocab = 4, 4, 384, 21128
    cfg = ColbertConfig(
        ce_model=ModelConfig(vocab_size=vocab, hidden_size=1024, num_layers=24, num_heads=16,
                             intermediate_size=4096, max_position_embeddings=512, dtype="bfloat16"),
        ce_train=CETrainConfig(per_device_batch_size=batch, neg_num=neg, seed=1234,
                               checkpoint_dir=tempfile.mkdtemp(prefix="ce_step_time_")),
    )
    t = CETrainer(cfg, tokenizer=None, device="cuda")
    t._init_state(args.steps + 3)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, vocab, size=(batch * (1 + neg), seqlen)).astype(np.int64)
    attn = np.ones_like(ids)
    group = 1 + neg

    calls = []
    apply = dr._apply

    def timed_apply(x, seed, thr, *where):
        t0 = time.perf_counter()
        out = apply(x, seed, thr, *where)
        calls.append(time.perf_counter() - t0)
        return out

    for step in range(2):
        t.train_step(ids, attn, group, None, step)
    torch.cuda.synchronize()
    dr._apply = timed_apply
    step_ms = []
    try:
        for step in range(2, 2 + args.steps):
            t0 = time.perf_counter()
            loss = t.train_step(ids, attn, group, None, step)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        dr._apply = apply
    if not np.isfinite(float(loss)):
        raise AssertionError(f"loss {float(loss)} is not finite")
    per_call = [c * 1e6 for c in calls]
    print(f"CE step, 24 x 1024 bf16, {batch} x (1 + {neg}) x {seqlen}: {args.steps} steps, ms "
          f"{[round(s, 1) for s in step_ms]}; mean {statistics.mean(step_ms):.1f}, median "
          f"{statistics.median(step_ms):.1f}, least {min(step_ms):.1f}; K9: {len(calls) // args.steps} calls a step, "
          f"host inside them {sum(calls) * 1e3 / args.steps:.3f} ms a step, a call least {min(per_call):.1f} / "
          f"median {statistics.median(per_call):.1f} / mean {statistics.mean(per_call):.1f} us")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t.train_step(ids, attn, group, None, 2 + args.steps)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in events) / 1e3
    k9 = [e for e in events if "dropout" in e.key or "packed_kernel" in e.key or "simple_kernel" in e.key]
    if not events:
        print("profiled step: the profiler saw no device time (not measured)")
    else:
        print(f"profiled step: kernels {busy:.3f} ms on the card in {sum(e.count for e in events)} launches; K9 "
              f"{sum(e.device_time_total for e in k9) / 1e3:.3f} ms in {sum(e.count for e in k9)} launches "
              f"({', '.join(sorted({e.key[:60] for e in k9}))})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
