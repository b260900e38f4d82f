"""Where a training step's time goes on the card: a torch.profiler breakdown.

    python -m colbert_tpu_torch.profile_train [--set KEY=VALUE ...]

Builds the retriever at BERT-base width from a seeded random init (the
``chip_smoke.py`` training configuration: hidden 768, 12 layers, bf16,
multiview 16/16, query_maxlen 32, doc_maxlen 384, dropout 0.1 through
kernel K9) at the default batch of 34 queries, runs 3 warm-up train steps
on seeded random token batches (docs of 60-140 tokens padded to 384, as no
length buckets are set; the batches are made before the timing, so no
tokenizer runs beside the steps), times 5 steps without the profiler,
then profiles 5 more.  Prints the card's name and power limit, the wall-clock
ms per step without and under the profiler (its host overhead inflates
the latter), the device time per step by kernel family, the busy share
of the unprofiled step, the top kernels, and one JSON line with the same
numbers.  ``--set`` overrides fields of the model's configuration, e.g.
``--set hidden_size=384 intermediate_size=1536 vocab_size=250037
dim=384 attention_impl=flash`` for ``chip_smoke.py`` phase 12's
MiniLM-L12-H384 width on the flash path.
Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from collections import defaultdict

FAMILIES = (  # first match wins
    ("K11-K13 flash attention and its rows kernel (ours)", r"flash_"),
    ("K9 dropout (ours)", r"dropout_kernel"),
    ("K3 maxsim (ours)", r"maxsim_kernel"),
    ("GEMM (cuBLAS)", r"gemm|xmma|cutlass|nvjet|Kernel2|cublas"),
    ("softmax", r"softmax"),
    ("reduction", r"reduce"),
    ("embedding", r"embedding|index"),
    ("optimizer (foreach)", r"multi_tensor|foreach"),
    ("elementwise (casts, adds, scales, masks)", r"elementwise|copy"),
)


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if re.search(pat, name, re.IGNORECASE):
            return fam
    return "other"


WARMUP, STEPS = 3, 5


def model_overrides(pairs, model) -> dict:
    """``KEY=VALUE`` strings as values of ``model``'s fields, each of its field's type."""
    out = {}
    for pair in pairs:
        key, _, text = pair.partition("=")
        if not hasattr(model, key):
            raise SystemExit(f"profile_train: the model's configuration has no field {key!r}")
        cur = getattr(model, key)
        out[key] = text.lower() in ("1", "true") if isinstance(cur, bool) else type(cur)(text)
    return out


def main(argv=None) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", nargs="+", default=[], metavar="KEY=VALUE", help="fields of the model's configuration")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA card", file=sys.stderr)
        return 1
    from colbert_tpu_torch.config import ColbertConfig
    from colbert_tpu_torch.training import ColbertTrainer, TrainBatch

    label = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(label, flush=True)
    cfg = ColbertConfig()
    for key, val in model_overrides(args.set, cfg.model).items():
        setattr(cfg.model, key, val)
    trainer = ColbertTrainer(cfg, None, device="cuda")
    trainer._init_state(total_steps=1000)
    rng = np.random.default_rng(cfg.train.seed)
    B, group = cfg.train.per_device_batch_size, cfg.train.train_num_positives + cfg.train.train_num_negatives
    Lq, Ld = cfg.tokenizer.query_maxlen, cfg.tokenizer.doc_maxlen

    def side(rows, L, lo, hi):
        ids = rng.integers(1000, cfg.model.vocab_size, size=(rows, L)).astype(np.int32)
        attn = (np.arange(L)[None, :] < rng.integers(lo, hi, size=rows)[:, None]).astype(np.int32)
        return ids * attn, attn

    def batch():
        q_ids, q_attn = side(B, Lq, 20, Lq + 1)
        d_ids, d_attn = side(B * group, Ld, 60, 141)
        return TrainBatch(q_ids, q_attn, np.ones((B, cfg.multiview.q_view), np.int32), d_ids, d_attn,
                          np.ones((B * group, cfg.multiview.d_view), np.int32))

    batches = [batch() for _ in range(WARMUP + 2 * STEPS)]
    for s in range(WARMUP):
        trainer.train_step(batches[s], s)
    torch.cuda.synchronize()

    def timed_steps(first):
        """Mean ms per step: until the host has issued the step's work, and until it is done."""
        issued, walls = [], []
        for s in range(first, first + STEPS):
            t0 = time.perf_counter()
            loss = trainer.train_step(batches[s], s)
            issued.append(time.perf_counter() - t0)
            float(loss)  # waits for the step
            walls.append(time.perf_counter() - t0)
        return 1e3 * sum(issued) / STEPS, 1e3 * sum(walls) / STEPS

    issue_ms, unprofiled_ms = timed_steps(WARMUP)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, ms_step = timed_steps(WARMUP + STEPS)

    kernels = defaultdict(lambda: [0.0, 0])  # name -> [device us, calls]
    for e in prof.key_averages():
        annotation = "#" in e.key or e.key.startswith("ProfilerStep")  # host ranges shown on the device row
        if e.self_device_time_total > 0 and not annotation and str(e.device_type).endswith("CUDA"):
            kernels[e.key][0] += e.self_device_time_total
            kernels[e.key][1] += e.count
    dev_ms = sum(v[0] for v in kernels.values()) / 1e3 / STEPS
    fams = defaultdict(float)
    for name, (us, _) in kernels.items():
        fams[family(name)] += us / 1e3 / STEPS
    launches = sum(v[1] for v in kernels.values()) / STEPS
    m = cfg.model
    print(f"train step, hidden {m.hidden_size}, {m.num_layers} layers, {m.num_heads} heads, attention "
          f"{m.attention_impl}, batch {B} ({B} x {Lq} + {B * group} x {Ld} tokens): "
          f"{unprofiled_ms:.1f} ms/step wall over {STEPS} steps without the profiler (the host "
          f"issued each step's work in {issue_ms:.1f} ms), {ms_step:.1f} under it; "
          f"{dev_ms:.1f} ms/step of kernels in {launches:.0f} launches "
          f"(busy {100 * dev_ms / unprofiled_ms:.1f}% of the unprofiled step) [{label}]")
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:45s} {ms:8.2f} ms/step  {100 * ms / dev_ms:5.1f}%")
    print("top kernels (ms/step, launches/step):")
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / 1e3 / STEPS:8.2f}  {n / STEPS:6.1f}  {name[:110]}")
    print(json.dumps({"card": label, "model": model_overrides(args.set, cfg.model), "ms_step": unprofiled_ms, "issue_ms_step": issue_ms, "profiled_ms_step": ms_step,
                      "device_ms_step": dev_ms, "launches_step": launches, "families_ms_step": dict(fams)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
