"""Phase 13b's fp32 check of the model-axis backward, sound and with planted faults, on the card.

``chip_smoke.tp_fp32_compare`` runs 3 train steps at BERT-base width (phase
13b's configuration: flash, dropout "byte" on, in fp32 with Adam's eps at
1e-6) at ``mesh.model = 2`` against ``mesh.model = 1`` and holds the losses,
step 1's gradients and the parameters to ``chip_smoke.TP_FP32_TOL``.  This
script takes its readings three times:

* ``sound``: as ``chip_smoke.py`` phase 13b does;
* ``one_site``: the broadcast's backward (``parallel/collectives.py``)
  drops the last position's gradient once, at the first backward call of
  the model-2 run (one layer's input gradient loses one position's part);
* ``every_site``: it drops it at every call.

Each run's readings and whether they pass the limits go to
``chiprun_out/tp_planted_fault.json``; the card's name and power limit are
printed.  Exits 1 unless the sound run passes and both faults fail.

    python3 scripts/tp_planted_fault.py
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def planted(collectives, every: bool):
    """A stand-in for the broadcast's backward that drops the last
    position's gradient (at its first call with several positions, or at
    every such call), and a function that puts the original back."""
    cls = collectives._Broadcast
    original = cls.backward
    calls = []

    def backward(ctx, *grads):
        if len(grads) > 1 and (every or not calls):
            calls.append(1)
            grads = (*grads[:-1], None)
        return original(ctx, *grads)

    cls.backward = staticmethod(backward)
    return lambda: setattr(cls, "backward", staticmethod(original)), calls


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tp_planted_fault: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from colbert_tpu_torch.ops import _build
    from colbert_tpu_torch.parallel import collectives

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_libraries("dropout", "flash_attention")
    device = torch.device("cuda", 0)
    label = cs.card_label()
    print(label, flush=True)
    out = {}
    with tempfile.TemporaryDirectory(prefix="tp_planted_fault_") as tmp:
        cfg, train_path, _ = cs.train_setup(Path(tmp), batch=34, steps=3, n_dev=4, attention_impl="flash")
        group = cs.tp_group(device)
        for name in ("sound", "one_site", "every_site"):
            undo, calls = planted(collectives, name == "every_site") if name != "sound" else (lambda: None, [])
            try:
                out[name] = cs.tp_fp32_compare(device, cfg, train_path, group, 3)
            finally:
                undo()
            out[name]["dropped"] = len(calls)
            r = out[name]
            print(f"[{name}] losses relative {r['loss_rel']:.3e}; step-1 gradients max|d| {r['grad_max_diff']:.3e} "
                  f"({r['grad_max_at']}) = {r['grad_ratio']:.3e} of the largest, |d|/|g| at most {r['grad_rel']:.3e} "
                  f"({r['grad_rel_at']}); parameters max|d| {r['param_max_diff']:.3e} ({r['param_max_at']}); "
                  f"{len(calls)} gradients dropped; within {cs.TP_FP32_TOL}: {r['ok']}", flush=True)
    out["limit"], out["label"], out["group"] = cs.TP_FP32_TOL, label, [str(d) for d in group]
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "tp_planted_fault.json").write_text(json.dumps(out, indent=1, default=str))
    print(label, flush=True)
    ok = out["sound"]["ok"] and not out["one_site"]["ok"] and not out["every_site"]["ok"]
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
