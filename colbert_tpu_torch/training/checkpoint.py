"""Training checkpoints: counterpart of ``colbert_tpu/training/checkpoint.py``.

The same directory scheme (``checkpoint-<step>/``, ``meta.json`` with the
metrics and the config, the newest ``keep`` kept), written with
``torch.save`` instead of orbax::

    checkpoint-<step>/
      pytorch.bin     the parameters in the reference layout
                      (``models/convert.py::reference_state_dict``), which the
                      JAX package's ``--pretrain`` also reads
      train_state.pt  the optimizer state and the step
      meta.json       metrics and config

``pytorch.bin`` is written last, by rename, and marks a finished
checkpoint.  RNG state needs no file: dropout seeds derive from
``(train.seed, step)``, so resuming at a step reproduces the stream.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from colbert_tpu_torch.utils.logging import get_logger

logger = get_logger("checkpoint")

_STEP_RE = re.compile(r"^checkpoint-(\d+)$")
PARAMS_FILE = "pytorch.bin"
STATE_FILE = "train_state.pt"


def _save_atomic(obj: Any, path: Path) -> None:
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 20):
        self.dir = Path(directory).absolute()
        self.keep = keep

    def path(self, step: int) -> Path:
        return self.dir / f"checkpoint-{step}"

    def all_steps(self) -> List[int]:
        if not self.dir.is_dir():
            return []
        steps = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and (self.dir / name / PARAMS_FILE).exists():
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, params: Dict[str, torch.Tensor], train_state: Dict[str, Any],
             metadata: Optional[Dict[str, Any]] = None) -> str:
        path = self.path(step)
        path.mkdir(parents=True, exist_ok=True)
        (path / PARAMS_FILE).unlink(missing_ok=True)  # unfinished until rewritten
        _save_atomic(train_state, path / STATE_FILE)
        if metadata is not None:
            with open(path / "meta.json", "w", encoding="utf8") as f:
                json.dump(metadata, f, indent=2)
        _save_atomic(params, path / PARAMS_FILE)
        logger.info("saved checkpoint step=%d -> %s", step, path)
        self._gc()
        return str(path)

    def params_path(self, step: int) -> Path:
        return self.path(step) / PARAMS_FILE

    def load_train_state(self, step: int) -> Dict[str, Any]:
        return torch.load(self.path(step) / STATE_FILE, map_location="cpu", weights_only=True)

    def load_metadata(self, step: int) -> Optional[Dict[str, Any]]:
        p = self.path(step) / "meta.json"
        if p.exists():
            with open(p, "r", encoding="utf8") as f:
                return json.load(f)
        return None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.path(s), ignore_errors=True)
